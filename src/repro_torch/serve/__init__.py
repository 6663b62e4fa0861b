from repro_torch.serve.engine import RequestTooLarge, ServeEngine
from repro_torch.serve.scheduler import (Completion,
                                         ContinuousBatchingScheduler,
                                         InvalidRequest, PoolExhausted,
                                         Request, oracle_completion,
                                         synthetic_workload)

__all__ = ["Completion", "ContinuousBatchingScheduler", "InvalidRequest",
           "PoolExhausted", "Request", "RequestTooLarge", "ServeEngine",
           "oracle_completion", "synthetic_workload"]
