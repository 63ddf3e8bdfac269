"""chip_smoke.py --four off the card: the sharded forward, gradient and
wire steps on four of the suite's virtual CPU devices, against one
device (the RT kernel in the Pallas interpreter)."""

import chip_smoke as cs


def test_four_phase_tiny_on_cpu():
    cs.phase_four(B1=8, L=8, interpret=True)
