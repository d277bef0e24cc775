from .api import from_formula  # noqa: F401
