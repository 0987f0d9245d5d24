"""Boosting drivers of the port: GBDT, DART and RF.

Factory analog of ``Boosting::CreateBoosting`` (boosting.cpp:34), as
``lightgbm_tpu/boosting/__init__.py:10``; ``boosting=goss`` is resolved
to gbdt + goss sampling by the Config layer.
"""

from .gbdt import GBDT


def create_boosting(config, train_set, objective, valid_sets=(), **kwargs):
    """``kwargs``: continued training's ``init_row_scores``,
    ``valid_init_row_scores`` and ``num_init_iteration``."""
    name = config.boosting
    if name == "gbdt":
        return GBDT(config, train_set, objective, valid_sets, **kwargs)
    if name == "dart":
        from .dart import DART
        return DART(config, train_set, objective, valid_sets, **kwargs)
    if name == "rf":
        from .rf import RF
        return RF(config, train_set, objective, valid_sets, **kwargs)
    raise ValueError(f"Unknown boosting type {name}")


__all__ = ["GBDT", "create_boosting"]
