"""The continual-learning runtime (counterpart of `repro.runtime`): the
composition root (`ContinualRuntime`, `edgeol_session`, `RuntimeConfig`),
the one-device `DeviceFleet` and its `DeviceRuntime`, the `ModelPool`,
scheduler, cost model, ledger, inference server, train steps (eager, and
the compiled path's CUDA graphs) and the fine-tuning executor.
`PodCostModel`, the TPU pod's cost model, is not ported (ROADMAP A.9)."""
from repro_torch.env.spec import EnvSpec
from repro_torch.obs.spec import TelemetrySpec
from repro_torch.runtime.config import (DeviceConfig, HookSpec, RuntimeConfig,
                                        SlotConfig, build_hook,
                                        materialize_stream_benchmarks)
from repro_torch.runtime.continual import (ContinualRuntime, RunResult,
                                           edgeol_session)
from repro_torch.runtime.costmodel import EdgeCostModel, scale_cost
from repro_torch.runtime.device import DeviceRuntime
from repro_torch.runtime.executor import (FineTuneExecutor, ReplayBuffer,
                                          RoundHook, RoundReport)
from repro_torch.runtime.fleet import (FLEET_STREAM, ROUTING_POLICIES,
                                       DeviceFleet, LeastLoaded,
                                       RoutingPolicy, StaticAffinity,
                                       fleet_devices)
from repro_torch.runtime.inference import InferenceServer
from repro_torch.runtime.ledger import (BREAKDOWN_KEYS, DEFAULT_DEVICE,
                                        DEFAULT_MODEL, DEVICE_KEYS,
                                        MODEL_KEYS, STREAM_KEYS, CostLedger)
from repro_torch.runtime.modelpool import ModelPool, ModelSlot
from repro_torch.runtime.scheduler import EventScheduler
from repro_torch.runtime.train_loop import TrainStepCache, evaluate

__all__ = ["EdgeCostModel", "ContinualRuntime", "RunResult",
           "TrainStepCache", "evaluate", "EventScheduler", "InferenceServer",
           "FineTuneExecutor", "ReplayBuffer", "RoundHook", "RoundReport",
           "CostLedger", "BREAKDOWN_KEYS", "STREAM_KEYS", "MODEL_KEYS",
           "DEVICE_KEYS", "DEFAULT_MODEL", "DEFAULT_DEVICE", "ModelPool",
           "ModelSlot", "RuntimeConfig", "SlotConfig", "HookSpec",
           "DeviceConfig", "edgeol_session", "build_hook",
           "materialize_stream_benchmarks", "scale_cost", "DeviceRuntime",
           "DeviceFleet", "RoutingPolicy", "StaticAffinity", "LeastLoaded",
           "ROUTING_POLICIES", "FLEET_STREAM", "fleet_devices",
           "TelemetrySpec", "EnvSpec"]
