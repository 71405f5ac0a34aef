"""Serving: the frozen forest, the micro-batcher, the replica fleet with
its health watchdog and hot reload, the guarded model lifecycle and the
HTTP server (the JAX package's ``serve`` names).

``forest``    -- :class:`CompiledForest`, served by the forest-walk
                 kernel K4 (``serve_walk=gather``: the plain per-level
                 walk); ``to_device`` makes a replica's copy.
``batcher``   -- :class:`BucketLadder` and the :class:`MicroBatcher`
                 (bounded queue, per-model metric labels).
``fleet``     -- :class:`Fleet` of replicas: least-loaded dispatch,
                 admission control, canary routing, hedged retries,
                 deadlines, and :class:`ModelManager` hot reload with a
                 crash-safe state file.
``health``    -- the replica state machine and its :class:`Watchdog`.
``lifecycle`` -- :class:`GuardrailPolicy`, :class:`PromotionController`,
                 :class:`ShadowScorer`, :class:`FeedbackTracker`.
``server``    -- the stdlib HTTP front end (``python -m
                 lightgbm_tpu_torch task=serve``).
"""

from .batcher import (BatcherClosed, BucketLadder, DeadlineExpired,
                      MicroBatcher, QueueFull, default_ladder)
from .fleet import (Fleet, FleetResult, ModelManager, Overloaded, Replica,
                    ReplicaSet, fleet_devices)
from .forest import CompiledForest
from .health import NoHealthyReplicas, ReplicaEjected, Watchdog
from .lifecycle import (FeedbackTracker, GuardrailPolicy,
                        PromotionController, ShadowScorer)
from .server import PredictServer, serve_from_config

__all__ = ["CompiledForest", "BucketLadder", "MicroBatcher", "QueueFull",
           "BatcherClosed", "DeadlineExpired",
           "default_ladder", "Fleet", "FleetResult", "ModelManager",
           "Overloaded", "Replica", "ReplicaSet", "fleet_devices",
           "NoHealthyReplicas", "ReplicaEjected", "Watchdog",
           "FeedbackTracker", "GuardrailPolicy", "PromotionController",
           "ShadowScorer",
           "PredictServer", "serve_from_config"]
