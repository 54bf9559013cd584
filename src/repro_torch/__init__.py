"""PyTorch/CUDA port of the ``repro`` serving stack.

The package mirrors ``src/repro`` module by module and imports neither JAX
nor ``repro``: modules it shares with the reference are kept as copies.
Entry points (:class:`repro_torch.models.model.Model`,
:class:`repro_torch.serve.engine.ServeEngine`, ``launch/serve.py``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
