from .averager_zoo import AVERAGER_ZOO, VariantInfo, run_variant  # noqa: F401

__all__ = ["AVERAGER_ZOO", "VariantInfo", "run_variant"]
