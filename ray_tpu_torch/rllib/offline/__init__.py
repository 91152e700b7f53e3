from ray_tpu_torch.rllib.offline.json_reader import JsonReader
from ray_tpu_torch.rllib.offline.json_writer import JsonWriter

__all__ = ["JsonReader", "JsonWriter"]
