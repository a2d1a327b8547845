from . import mips, evaluator, ann  # noqa: F401
