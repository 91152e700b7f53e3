"""Attention ops of the port: ``flash_attention`` (the forward through a
CUDA kernel written by hand for Hopper, with its plain PyTorch version)
and ``blockwise_attention`` (the online-softmax recurrence in plain
PyTorch). The submodules are not re-exported here, so that
``ray_tpu_torch.ops.flash_attention`` stays the module that holds the
kernel's launch counter."""
