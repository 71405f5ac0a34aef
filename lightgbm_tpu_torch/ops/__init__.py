"""Device ops: the growers and their histogram kernels, the split scan,
the plain gather walk and the forest-walk kernel."""

from .grow import GrowParams, TreeArrays, grow_tree
from .split import BestSplit, SplitParams, find_best_split, leaf_output

__all__ = ["BestSplit", "GrowParams", "SplitParams", "TreeArrays",
           "find_best_split", "grow_tree", "leaf_output"]
