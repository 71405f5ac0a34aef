"""Distributed training over ``torch.distributed``.

The port's counterpart of the JAX package's parallel/: the learners'
communication strategies (``comm.py``), the distributed grower
(``grow.py``), the bring-up from the reference's machine list
(``multihost.py``) and the sharded ingestion with the distributed
FindBin (``ingest.py``).  The collective watchdog and the consistency
check of the JAX package are not ported.
"""

from .comm import (DataParallelComm, FeatureParallelComm,  # noqa: F401
                   VotingParallelComm)
from .grow import make_comm, make_parallel_grow  # noqa: F401
