"""``tests/test_torch_imports.py``'s test scripts that run on the card, each
imported in a fresh interpreter with JAX and the reference blocked, in a
file of at most 3 tests (xdist hands it out late).
"""

import pytest

from test_torch_imports import CARD_SCRIPTS, check_card_script
from torch_share import cpu_share  # noqa: F401


@pytest.mark.parametrize("script", CARD_SCRIPTS[1:])
def test_card_scripts_import_neither_jax_nor_the_reference(script):
    check_card_script(script)
