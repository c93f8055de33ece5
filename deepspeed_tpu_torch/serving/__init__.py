"""Serving layer: persistent request-lifecycle subsystem over InferenceEngineV2.

Port of ``deepspeed_tpu/serving/``. Reference: DeepSpeed-FastGen/MII's
persistent deployment (Holmes et al. 2024) — continuous admission, Dynamic
SplitFuse chunked-prefill/decode interleaving (iteration-level scheduling per
Orca, Yu et al. OSDI'22), per-request token streaming, deadlines, and
backpressure, with the prefix cache, the KV tier ladder
(``serving/kv_tiers.py``), the handoff, session parking and speculative
decoding (``SpeculativeConfig``).

Usage::

    from deepspeed_tpu_torch.serving import ServingConfig, ServingScheduler, ServingServer

    scheduler = ServingScheduler(engine, ServingConfig(decode_chunk=4))
    req = scheduler.submit(prompt_tokens, max_new_tokens=64, deadline_s=2.0)
    for token in req.stream:          # streams as the scheduler generates
        ...
    server = ServingServer(scheduler).start()   # POST /v1/generate (SSE), GET /v1/stats
    server.stop()                               # graceful drain
"""

from deepspeed_tpu_torch.serving.config import (KVTierConfig, OverloadConfig,
                                                PrefixCacheConfig, ServingConfig,
                                                SpeculativeConfig)
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.overload import (PRIORITIES, BrownoutController,
                                                  RateEstimator)
from deepspeed_tpu_torch.serving.request import (Request, RequestState, TERMINAL_STATES,
                                                 TokenStream)
from deepspeed_tpu_torch.serving.scheduler import (AdmissionRejected, QueueFullError,
                                                   SchedulerStopped, ServingScheduler)
from deepspeed_tpu_torch.serving.server import ServingServer

__all__ = [
    "KVTierConfig", "OverloadConfig", "PrefixCacheConfig", "SpeculativeConfig", "PRIORITIES",
    "BrownoutController", "RateEstimator",
    "ServingConfig", "ServingMetrics", "Request", "RequestState", "TERMINAL_STATES",
    "TokenStream", "ServingScheduler", "AdmissionRejected", "QueueFullError",
    "SchedulerStopped", "ServingServer",
]
