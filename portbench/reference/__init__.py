"""The plain reference: numpy and plain torch, importing nothing of the
program (``design``: what set-up derives from the HRIRs; ``render``: the
filterbank, mixing and synthesis)."""
