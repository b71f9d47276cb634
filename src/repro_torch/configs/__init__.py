from .registry import ARCHS, get_config, reduced_config  # noqa: F401
