"""Prime-field layer of the PyTorch port: Goldilocks and BabyBear."""

from .field import (BABYBEAR, FIELDS, GOLDILOCKS, BabyBear, Goldilocks,
                    get_field)

__all__ = ["GOLDILOCKS", "Goldilocks", "BABYBEAR", "BabyBear", "FIELDS",
           "get_field"]
