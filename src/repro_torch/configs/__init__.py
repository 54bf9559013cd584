from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config, list_archs  # noqa: F401
from repro_torch.configs.shapes import SHAPES, applicable, config_for_shape, input_specs  # noqa: F401
