from .mesh import make_mesh, replicate, shard_rows, shard_rows_cols  # noqa: F401
from .design import DeviceDesign  # noqa: F401
from .distributed import (  # noqa: F401
    MixedDesign,
    build_mixed_design,
    design_matvec,
    design_transpose_matvec,
    mixed_irls_step,
)
