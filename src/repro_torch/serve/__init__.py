from repro_torch.serve.engine import EngineConfig, Request, ServeEngine  # noqa: F401
from repro_torch.serve.fused_decode import (fused_decode_run,  # noqa: F401
                                            sampled_decode_step)
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig  # noqa: F401
from repro_torch.serve.telemetry import (RollingMonitor, StepClock,  # noqa: F401
                                         Telemetry, percentile)
from repro_torch.serve.tracegen import (TraceConfig, TraceItem,  # noqa: F401
                                        generate, replay)
