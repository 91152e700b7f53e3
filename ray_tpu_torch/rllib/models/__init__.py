from ray_tpu_torch.rllib.models.catalog import ModelCatalog

__all__ = ["ModelCatalog"]
