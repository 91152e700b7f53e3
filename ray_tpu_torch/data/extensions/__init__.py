from ray_tpu_torch.data.extensions.tensor_extension import (ArrowTensorArray,
                                                      ArrowTensorType)

__all__ = ["ArrowTensorArray", "ArrowTensorType"]
