from repro_torch.serve.chaos import ChaosInjector, ChaosPolicy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import (AdmissionRejected, BlockAllocatorError,
                                      BlockNotLive, BlockOutOfRange,
                                      DeadlineExceeded, FaultInjected,
                                      FrontendError, InvalidRequest, LoadShed,
                                      PoolExhausted, QueueFull,
                                      RequestCancelled, RequestTooLarge,
                                      RetriesExhausted, SchedulerError,
                                      SchedulerStalled)
from repro_torch.serve.frontend import (FrontendConfig, RequestHandle,
                                        ServeFrontend, ServeResult)
from repro_torch.serve.policies import (QueueEntry, RequestQueue, RetryPolicy,
                                        VirtualClock)
from repro_torch.serve.scheduler import (Completion,
                                         ContinuousBatchingScheduler,
                                         Request, TickResult,
                                         oracle_completion,
                                         synthetic_workload)

__all__ = ["AdmissionRejected", "BlockAllocatorError", "BlockNotLive",
           "BlockOutOfRange", "ChaosInjector", "ChaosPolicy", "Completion",
           "ContinuousBatchingScheduler", "DeadlineExceeded",
           "FaultInjected", "FrontendConfig", "FrontendError",
           "InvalidRequest", "LoadShed", "PoolExhausted", "QueueEntry",
           "QueueFull", "Request", "RequestCancelled", "RequestHandle",
           "RequestQueue", "RequestTooLarge", "RetriesExhausted",
           "RetryPolicy", "SchedulerError", "SchedulerStalled",
           "ServeEngine", "ServeFrontend", "ServeResult", "TickResult",
           "VirtualClock", "oracle_completion", "synthetic_workload"]
