"""repro_torch — the ZeRO++ serving path ported to PyTorch and CUDA (Hopper).

A second package beside the JAX reference ``repro``.  It imports torch,
numpy and the standard library only; its tests hold every module against
its ``repro`` counterpart on the same numpy inputs.  Entry points
(``models.model.Model``, ``serve.steps.build_*_step``, ``serve.engine.
ServeEngine``) run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""
__version__ = "0.1.0"
