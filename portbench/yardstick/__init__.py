"""The benchmark's own measuring rules, frozen here so that a change to the
program cannot move them: the card's published peaks, the bounds of the
two kernels' work, the model-FLOP count, the device-trace reduction, the
traffic generator and the seeded weights."""
