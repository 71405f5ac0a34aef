"""In-data column roles: the label, weight, group, ignored and
categorical columns, by index or by ``name:``.

Port of the JAX package's io/column_roles.py (reference
DatasetLoader::SetHeader, dataset_loader.cpp:22-157):

* ``label_column`` resolves against the full header (every column);
  the default is column 0.
* Every other role resolves in the column space with the label removed
  (``ignore_column=0`` is the first column that is not the label).
* ``weight_column`` and ``group_column`` name one column each; both
  become ignored features (their values feed the metadata instead).
* ``ignore_column`` and ``categorical_column`` are comma-separated lists.
* A ``name:`` entry needs a header; a name not in it, or a bare entry
  that is not an integer, raises ``LightGBMError``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Set

import numpy as np

from ..utils import log

_NAME_PREFIX = "name:"


class ColumnRoles(NamedTuple):
    """Resolved roles, all in label-removed (feature-space) indices."""
    weight_idx: int         # -1: none
    group_idx: int          # -1: none
    ignore: Set[int]        # includes the weight and group columns
    categorical: Set[int]


def _to_int(token: str, what: str) -> int:
    try:
        return int(token)
    except ValueError:
        log.fatal("%s is not a number, if you want to use a column name, "
                  "please add the prefix \"name:\" to the column name",
                  what)


def _one(spec: str, name2idx: Optional[dict], what: str) -> int:
    if spec.startswith(_NAME_PREFIX):
        name = spec[len(_NAME_PREFIX):]
        if name2idx is None or name not in name2idx:
            log.fatal("Could not find %s column %s in data file", what, name)
        return name2idx[name]
    return _to_int(spec, what)


def _many(spec: str, name2idx: Optional[dict], what: str) -> Set[int]:
    if spec.startswith(_NAME_PREFIX):
        out = set()
        for name in spec[len(_NAME_PREFIX):].split(","):
            if name2idx is None or name not in name2idx:
                log.fatal("Could not find %s column %s in data file",
                          what, name)
            out.add(name2idx[name])
        return out
    return {_to_int(token, what) for token in spec.split(",") if token}


def resolve_label_idx(label_column: str,
                      full_names: Optional[Sequence[str]]) -> int:
    """The label column in the full column space
    (dataset_loader.cpp:35-59)."""
    if not label_column:
        return 0
    if label_column.startswith(_NAME_PREFIX):
        name = label_column[len(_NAME_PREFIX):]
        if full_names and name in full_names:
            log.info("Using column %s as label", name)
            return list(full_names).index(name)
        log.fatal("Could not find label column %s in data file or data "
                  "file doesn't contain header", name)
    return _to_int(label_column, "label_column")


def resolve_roles(weight_column: str = "", group_column: str = "",
                  ignore_column: str = "", categorical_column: str = "",
                  feature_names: Optional[Sequence[str]] = None
                  ) -> ColumnRoles:
    """The other roles against the label-removed feature names
    (dataset_loader.cpp:61-157)."""
    name2idx = ({n: i for i, n in enumerate(feature_names)}
                if feature_names else None)
    ignore: Set[int] = set()
    if ignore_column:
        ignore |= _many(ignore_column, name2idx, "ignore_column")
    weight_idx = -1
    if weight_column:
        weight_idx = _one(weight_column, name2idx, "weight")
        log.info("Using column %s as weight", weight_column)
        ignore.add(weight_idx)
    group_idx = -1
    if group_column:
        group_idx = _one(group_column, name2idx, "group/query id")
        log.info("Using column %s as group/query id", group_column)
        ignore.add(group_idx)
    categorical: Set[int] = set()
    if categorical_column:
        categorical = _many(categorical_column, name2idx,
                            "categorical_column")
    return ColumnRoles(weight_idx, group_idx, ignore, categorical)


def qid_to_query_sizes(qids) -> List[int]:
    """The lengths of the consecutive runs of a per-row query-id column
    (Metadata::SetQueryId semantics)."""
    q = np.asarray(qids)
    if q.size == 0:
        return []
    change = np.nonzero(q[1:] != q[:-1])[0] + 1
    bounds = np.concatenate([[0], change, [q.size]])
    return list(np.diff(bounds).astype(int))
