"""The last two pinned seeds of ``tests/test_torch_stream_pinned.py``
(the reference's ``apply_many`` drain, copied by the port), in a file of
their own so that neither file runs much past a minute on the CPU."""

import pytest

pytest.importorskip("torch")

from test_torch_stream_pinned import SEEDS, check_pinned_seed  # noqa: E402


@pytest.mark.parametrize("seed", SEEDS[2:])
def test_lagger_apply_many_drain_matches_reference(seed):
    check_pinned_seed(seed)
