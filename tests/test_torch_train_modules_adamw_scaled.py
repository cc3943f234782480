"""``tests/test_torch_train_modules.py``'s AdamW update against optax, at
gradient scale 100.0, in a file of at most 3 tests (xdist hands it out
late); that file states the tolerances.
"""

import pytest

from test_torch_train_modules import check_adamw_update
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("paramwise", [(), (("rpn_head", 0.5),)])
@pytest.mark.parametrize("scale", [100.0])
def test_adamw_update_matches_optax(paramwise, scale):
    check_adamw_update(paramwise, scale)
