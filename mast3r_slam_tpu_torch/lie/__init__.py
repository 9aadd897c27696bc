from . import sim3  # noqa: F401
