from .design import DeviceDesign  # noqa: F401
