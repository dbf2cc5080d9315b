from repro_torch.serving.api import (AdmissionQueueFull,  # noqa: F401
                                     BeamConfig, DeadlineExceeded,
                                     DegradationPolicy, DegradedError,
                                     RejectedError, ResponseFuture,
                                     ServeMetrics, ServeRequest,
                                     ServeResponse, ServingEngine, ShedError,
                                     TopKConfig, WatchdogTimeout,
                                     available_engines, create_engine,
                                     register_engine)
# importing engine registers "flame", "implicit" and "text" in the registry
from repro_torch.serving.engine import (FlameEngine,  # noqa: F401
                                        ImplicitShapeServingEngine,
                                        TextServingEngine)
from repro_torch.serving.faults import (FaultInjected,  # noqa: F401
                                        FaultInjector)
from repro_torch.serving.kv_cache import (HistoryKVPool,  # noqa: F401
                                          KVCacheManager)
