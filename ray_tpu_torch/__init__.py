"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``'s ML stack.

A package of its own beside ``ray_tpu``: it imports ``torch`` and
``numpy`` and nothing of JAX or of ``ray_tpu``. Module paths mirror
``ray_tpu``'s so each port sits at the path of its counterpart:

* ``serve.continuous_batching`` — the iteration-level decode engine;
* ``models.gpt`` — the GPT family's dense inference path;
* ``ops.flash_attention`` — attention forward through a CUDA kernel
  written by hand for Hopper (``ops/csrc/flash_fwd.cu``), with its plain
  PyTorch version for tensors on the CPU;
* ``ops.blockwise_attention`` — the online-softmax recurrence in plain
  PyTorch (the flash wrapper's route for ragged sequence lengths).

Entry points take ``device=None``, meaning the CUDA card; they raise
``RuntimeError`` when there is none unless the caller asks for
``device="cpu"`` (see ``_private.device.resolve_device``).
"""

from ray_tpu_torch._private.device import resolve_device

__all__ = ["resolve_device"]
