from ray_tpu_torch.data._internal.execution.interfaces import (ExecutionOptions,
                                                         PhysicalOperator,
                                                         RefBundle)
from ray_tpu_torch.data._internal.execution.operators import (AllToAllOperator,
                                                        InputDataBuffer,
                                                        MapOperator)
from ray_tpu_torch.data._internal.execution.streaming_executor import (
    StreamingExecutor)

__all__ = ["AllToAllOperator", "ExecutionOptions", "InputDataBuffer",
           "MapOperator", "PhysicalOperator", "RefBundle",
           "StreamingExecutor"]
