"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

The JAX package (``deepspeed_tpu``) stays the reference; this package mirrors
its layout and public names module by module. The first slice is the serving
path: ``serving.LLMServer`` -> ``inference.v2.InferenceEngineV2`` -> the
ragged model forward, with the two paged-attention kernels hand-written for
Hopper (``ops/csrc/paged_attention.cu``). Entry points take a ``device``
argument that defaults to ``"cuda"``; the plain PyTorch versions of the
kernels run only when the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
