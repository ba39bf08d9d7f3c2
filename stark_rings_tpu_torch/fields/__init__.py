"""Prime-field layer of the PyTorch port: Goldilocks, BabyBear, frog and
the 8-limb stark prime."""

from .field import (BABYBEAR, FIELDS, FROG, GOLDILOCKS, STARK, BabyBear,
                    Frog, Goldilocks, Stark, get_field)

__all__ = ["GOLDILOCKS", "Goldilocks", "BABYBEAR", "BabyBear", "FROG",
           "Frog", "STARK", "Stark", "FIELDS", "get_field"]
