from repro_torch.parallel import mesh_ctx, sharding  # noqa: F401
