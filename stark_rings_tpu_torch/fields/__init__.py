"""Prime-field layer of the PyTorch port: Goldilocks, BabyBear and
frog."""

from .field import (BABYBEAR, FIELDS, FROG, GOLDILOCKS, BabyBear, Frog,
                    Goldilocks, get_field)

__all__ = ["GOLDILOCKS", "Goldilocks", "BABYBEAR", "BabyBear", "FROG",
           "Frog", "FIELDS", "get_field"]
