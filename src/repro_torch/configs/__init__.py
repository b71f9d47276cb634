from .registry import ARCHS, cut_layers, get_config, reduced_config  # noqa: F401
