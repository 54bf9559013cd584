from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config, list_archs  # noqa: F401
