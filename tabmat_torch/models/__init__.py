from .base import MatrixBase, one_over_var_inf_to_val  # noqa: F401
from .dense import DenseMatrix  # noqa: F401
from .standardized import StandardizedMatrix  # noqa: F401
from .split import as_tabmat, hstack  # noqa: F401
