"""Prime-field layer of the PyTorch port: Goldilocks, BabyBear, frog and
the 8-limb stark prime.  ``Field`` is the base class the four share."""

from .field import (BABYBEAR, FIELDS, FROG, GOLDILOCKS, STARK, BabyBear,
                    Frog, Goldilocks, Stark, get_field)
from .field import _PrimeField as Field

__all__ = ["Field", "GOLDILOCKS", "Goldilocks", "BABYBEAR", "BabyBear",
           "FROG", "Frog", "STARK", "Stark", "FIELDS", "get_field"]
