"""The reference's independent, spec-derived PHY golden vectors
(``tests/test_golden_phy.py``) run against the port's own modules: the Gold
sequence (36.211 7.2), the PSS Zadoff-Chu (6.11.1), the SSS (6.11.2), the
64QAM literals (Table 7.1.4-1), CRC24A/24B/16 (36.212 5.1.1), the turbo
encoder with its QPP interleaver (5.1.3.2), the tail-biting convolutional
encoder (5.1.3.1) and the convolutional sub-block interleaver (5.1.4.2.1).
The port is then checked against the specification, not only against the
JAX package. The port's functions on tensors (the mapper, the batched
tail-biting encoder, the +-1 Gold sequence) meet the same vectors.
"""

import numpy as np
import pytest
import torch

from srsue_tpu_torch.phy import convcode, modulation, seq
from test_torch_stack import _load, _scenarios

GOLDEN = _scenarios("test_golden_phy")


@pytest.mark.parametrize("scenario", GOLDEN)
def test_golden_vector_on_the_port(scenario):
    ns = _load("test_golden_phy", "srsue_tpu_torch")
    assert ns["seq"] is seq and ns["convcode"] is convcode
    ns[scenario]()


def test_every_golden_generator_is_run():
    assert len(GOLDEN) == 9


def test_64qam_literals_through_the_tensor_mapper():
    """Table 7.1.4-1's entries through ``modulation.modulate``."""
    cases = {(0, 0, 0, 0, 0, 0): (3, 3), (0, 0, 0, 0, 0, 1): (3, 1),
             (1, 1, 1, 1, 1, 1): (-7, -7), (1, 0, 1, 0, 1, 0): (-7, 3),
             (0, 0, 1, 1, 0, 0): (5, 5), (0, 0, 0, 0, 1, 1): (1, 1)}
    bits = torch.as_tensor(np.array(list(cases), np.uint8).reshape(1, -1))
    got = modulation.modulate(bits, 6).numpy()[0]
    want = np.array([complex(*v) for v in cases.values()]) / np.sqrt(42)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_tail_biting_encoder_on_tensors_vs_spec_registers():
    """36.212 5.1.3.1 as a literal shift register (the register starts with
    the last 6 bits), against ``convcode.encode_torch``."""
    bits = np.random.default_rng(13).integers(0, 2, (3, 50)).astype(np.uint8)
    got = convcode.encode_torch(torch.as_tensor(bits)).numpy()
    for row, out in zip(bits, got):
        state = list(row[-6:][::-1])
        ref = [[], [], []]
        for u in row:
            window = [int(u)] + state
            for j, poly in enumerate((0o133, 0o171, 0o165)):
                ref[j].append(sum(window[t] for t in range(7) if (poly >> (6 - t)) & 1) % 2)
            state = window[:-1]
        np.testing.assert_array_equal(out, np.array(ref, np.uint8))


def test_gold_sequence_as_signs_vs_spec_lfsr():
    ref = _load("test_golden_phy", "srsue_tpu_torch")["_gold_ref"]
    for c_init in (0, 0x1F2A3):
        np.testing.assert_array_equal(seq.prs_f32(c_init, 200),
                                      1.0 - 2.0 * ref(c_init, 200).astype(np.float32))
