from .registry import ARCHS, cell_status, cut_layers, extra_inputs, get_config, reduced_config  # noqa: F401
