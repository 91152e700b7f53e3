"""Attention ops of the port: ``flash_attention`` (the forward K1 and the
backward K2/K3 through CUDA kernels written by hand for Hopper, each with
its plain PyTorch version) and ``blockwise_attention`` (the online-softmax
recurrence in plain PyTorch). The submodules are not re-exported here, so
that ``ray_tpu_torch.ops.flash_attention`` stays the module that holds the
kernels' launch counters."""
