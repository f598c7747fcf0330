"""Continuous evaluation: the champion/challenger harness, the statistical
promotion gates and the drift detectors of the rollout path (counterpart
of ``dct_tpu/evaluation``)."""
