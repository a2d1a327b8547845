from . import sysinfo  # noqa: F401
