"""Serving subsystem: micro-batching scheduler, versioned model
registry with hot-swap, and a metrics-instrumented prediction server.

Port of ``lightgbm_tpu/serving/``, layered on
:class:`~lightgbm_tpu_torch.engine.PredictSession` and
:class:`~lightgbm_tpu_torch.codegen.CompiledEnsemble`: request
coalescing under a latency deadline (``batcher``), zero-downtime
deploys (``registry``), device-resident replicas (``replica``),
request-level observability (``metrics``), and an HTTP front end
(``server``). Models serve on ``device_type`` (default ``cuda``, which
raises without a GPU; ``cpu`` for the host)::

    srv = PredictionServer(port=0)
    srv.registry.register("default", "model.txt")
    srv.start()
"""

from .batcher import MicroBatcher, Overloaded, bucket_rows
from .metrics import Counter, RingHistogram, ServingMetrics
from .registry import ModelRegistry, ModelVersion
from .replica import BudgetExceeded, QpsBudget, ReplicaSet
from .server import PredictionServer

__all__ = ["MicroBatcher", "Overloaded", "bucket_rows", "Counter",
           "RingHistogram", "ServingMetrics", "ModelRegistry",
           "ModelVersion", "PredictionServer", "ReplicaSet",
           "QpsBudget", "BudgetExceeded"]
