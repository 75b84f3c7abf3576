"""The controller side of the port (counterpart of `repro.core`): the
ETuner controller and its policies, LazyTune with its accuracy-curve fit,
SimFreeze with its CKA probe, the energy-score drift detector and the
freeze plans."""
