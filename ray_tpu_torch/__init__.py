"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``'s ML stack.

A package of its own beside ``ray_tpu``: it imports ``torch`` and
``numpy`` and nothing of JAX or of ``ray_tpu``. Module paths mirror
``ray_tpu``'s so each port sits at the path of its counterpart:

* ``serve.continuous_batching`` — the iteration-level decode engine;
* ``models.gpt`` — the GPT family's dense path: forward, ``loss_fn``
  (chunked cross-entropy) and rematerialisation, for serving and
  training;
* ``models.llama`` — the Llama family (RMSNorm, SwiGLU, full-dim rotary,
  grouped-query attention): forward, ``loss_fn`` and rematerialisation;
* ``ops.flash_attention`` — flash attention through CUDA kernels written
  by hand for Hopper: the forward K1 (``ops/csrc/flash_fwd.cu``) and the
  backward K2 (dq) and K3 (dk, dv) (``ops/csrc/flash_bwd.cu``), whose
  bf16 versions share the TMA, ``mbarrier`` and ``wgmma`` machinery of
  ``ops/csrc/hopper.cuh``; each with its plain PyTorch version for
  tensors on the CPU;
* ``ops.blockwise_attention`` — the online-softmax recurrence in plain
  PyTorch (the flash wrapper's route for ragged sequence lengths);
* ``parallel.optim`` and ``parallel.train_step`` — optax's rules as plain
  functions on tensors (AdamW, Adafactor), and the one-device train step.

Entry points take ``device=None``, meaning the CUDA card; they raise
``RuntimeError`` when there is none unless the caller asks for
``device="cpu"`` (see ``_private.device.resolve_device``).
"""

from ray_tpu_torch._private.device import resolve_device

__all__ = ["resolve_device"]
