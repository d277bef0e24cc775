from .validation import (  # noqa: F401
    as_numpy_dtype,
    check_matvec_dimensions,
    check_matvec_out_shape,
    check_sandwich_compatible,
    check_transpose_matvec_out_shape,
    is_identity_index,
    set_up_rows_or_cols,
    setup_restrictions,
    _check_indexer,
)
from .arrays import (  # noqa: F401
    as_torch_dtype,
    to_tensor,
    to_numpy,
    result_like,
    add_into_out,
    rows_to_mask,
    cols_to_mask,
    tensor_bytes,
)
