"""Carry state across from the JAX package as plain numpy and text.

Nothing here imports ``lightgbm_tpu``: the JAX side hands over what its
own public methods produce (``BinMapper.state_arrays()`` tuples, model
text), so both packages can bin identically and predict from the same
trees.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .binning import BinMapper
from .engine import Booster

__all__ = ["bin_mappers_from_state", "booster_from_model_string"]


def bin_mappers_from_state(states: Iterable[Sequence[np.ndarray]]
                           ) -> List[BinMapper]:
    """Rebuild the port's mappers from ``BinMapper.state_arrays()``
    tuples ``(scalars int64[6], upper_bounds f64[*], categories i64[*])``
    (lightgbm_tpu/binning.py:340), one per feature. Pass them to
    ``Dataset(..., bin_mappers=...)`` to bin with the JAX package's
    mappers instead of fitting anew."""
    return [BinMapper.from_state_arrays(*(np.asarray(a) for a in st))
            for st in states]


def booster_from_model_string(text: str, params: Optional[Dict] = None
                              ) -> Booster:
    """Load a model the JAX package trained (its LightGBM-v4 model text).
    ``params`` may set ``device_type`` for prediction."""
    return Booster(model_str=text, params=params)
