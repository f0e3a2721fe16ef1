"""repro_torch.serving — the public serving API of the port
(``repro.serving``, DESIGN.md §10), with the same public names.

One declarative spec (`ServeSpec`), one factory (`build`), one client
surface (`LLMServer` with `generate` / `generate_stream` / `abort`) over a
`TorchBackend` engine, the roofline simulator, a trace replay, or a
globally-balanced cluster of engines or simulators.

    from repro_torch.serving import ServeSpec, SamplingParams, build

    server = build(ServeSpec(), device="cpu")      # a reduced engine
    out = server.generate([1, 2, 3], SamplingParams(max_new_tokens=8))
    print(out.token_ids, out.finish_reason)
"""

from repro_torch.core import SLO_BATCH, SLO_CLASSES, SLO_INTERACTIVE, SamplingParams
from repro_torch.runtime.disagg import ROLES, HandoffPolicy
from repro_torch.runtime.router import RebalancePolicy, ReplicaCapacity
from repro_torch.serving.build import build
from repro_torch.serving.http import HTTPFrontend
from repro_torch.serving.server import (
    EVENT_PREEMPT,
    EVENT_PREEMPT_RESUMED,
    FINISH_ABORT,
    FINISH_LENGTH,
    FINISH_STOP,
    LLMServer,
    ReplicaStats,
    RequestOutput,
    ServerStats,
    TokenDelta,
)
from repro_torch.serving.spec import (
    ClusterSpec,
    EngineSpec,
    ServeSpec,
    SimSpec,
    TraceSpec,
)

__all__ = [
    "SamplingParams",
    "SLO_BATCH",
    "SLO_CLASSES",
    "SLO_INTERACTIVE",
    "RebalancePolicy",
    "ReplicaCapacity",
    "HandoffPolicy",
    "ROLES",
    "build",
    "HTTPFrontend",
    "LLMServer",
    "RequestOutput",
    "TokenDelta",
    "ReplicaStats",
    "ServerStats",
    "FINISH_STOP",
    "FINISH_LENGTH",
    "FINISH_ABORT",
    "EVENT_PREEMPT",
    "EVENT_PREEMPT_RESUMED",
    "ClusterSpec",
    "EngineSpec",
    "SimSpec",
    "TraceSpec",
    "ServeSpec",
]
