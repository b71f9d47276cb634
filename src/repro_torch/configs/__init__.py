from .registry import ARCHS, cut_layers, extra_inputs, get_config, reduced_config  # noqa: F401
