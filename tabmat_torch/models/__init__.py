from .base import MatrixBase, one_over_var_inf_to_val  # noqa: F401
from .dense import DenseMatrix  # noqa: F401
from .standardized import StandardizedMatrix  # noqa: F401
from .categorical import CategoricalMatrix  # noqa: F401
from .sparse import SparseMatrix  # noqa: F401
from .split import SplitMatrix, as_tabmat, hstack  # noqa: F401
