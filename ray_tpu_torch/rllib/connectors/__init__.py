from ray_tpu_torch.rllib.connectors.connector import (ActionConnectorPipeline,
                                                ClipActions, Connector,
                                                FlattenObs, MeanStdFilter,
                                                ObsConnectorPipeline,
                                                get_connectors)

__all__ = ["ActionConnectorPipeline", "ClipActions", "Connector",
           "FlattenObs", "MeanStdFilter", "ObsConnectorPipeline",
           "get_connectors"]
