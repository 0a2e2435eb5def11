"""The example scenes on the card against the CPU, and the furnace on the
card: chip_smoke.py's phase 22 (a)-(c), with no JAX import, so that it runs
on a machine with a card:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_examples_cuda.py

It skips without a card.
"""
import pytest
import torch


@pytest.mark.cuda
def test_examples_on_the_card_match_the_cpu():
    """Each example scene loaded and tiered, the native OBJ parser run; the
    path tracer, direct and the light tracer on the examples and the
    oracle's point + directional, env-glass and uv-emission scenes, card
    against CPU (99.9% of pixels within 1e-3, means within 1e-4, only the
    tier's kernels launched); the furnace within 0.015 / 1e-3 of 0.5 / 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    chip_smoke.examples_check(torch.device("cuda"))
