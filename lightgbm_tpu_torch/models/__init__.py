"""Model text, the boosted forests and the boosting factory."""

from ..utils import log
from .dart import DART
from .gbdt import GBDT
from .goss import GOSS
from .tree import Tree

__all__ = ["DART", "GBDT", "GOSS", "Tree", "create_boosting"]


def create_boosting(config=None, train_set=None, objective=None,
                    device=None, model_str: str = ""):
    """The booster of ``config.boosting_type`` (boosting.cpp:8-71; the
    JAX ``create_boosting``), or of the submodel a model text names on
    its first line (``tree`` reads as ``gbdt``), which wins; with
    ``model_str`` the forest is loaded from it.  With ``train_set`` it
    trains on ``device`` (default the card; ``"cpu"`` runs the plain
    versions) with ``objective``, an objective instance (default the
    config's)."""
    boosting_type = config.boosting_type if config is not None else "gbdt"
    if model_str and model_str.strip():
        first = model_str.strip().splitlines()[0].strip()
        if first in ("gbdt", "dart", "goss", "tree"):
            boosting_type = "gbdt" if first == "tree" else first
    cls = {"gbdt": GBDT, "dart": DART, "goss": GOSS}.get(boosting_type)
    if cls is None:
        log.fatal("Unknown boosting type %s", boosting_type)
    model = cls(config, train_set, device, objective)
    if model_str:
        model.load_model_from_string(model_str)
    return model
