"""cnn_ms_per_image: milliseconds of the program's "Features computation"
phase per image it featurised, over the window's passes (the phase's
device-synchronised span, ``utils/profiling.PhaseTimer``). Layer: the CNN
(``models/feature_extractor.py``, ``models/cnn.py``)."""

PHASE = "Features computation"


def read(run):
    total = sum(p.phases[PHASE]["total_s"] for p in run.passes
                if PHASE in p.phases)
    count = sum(p.phases[PHASE]["count"] for p in run.passes
                if PHASE in p.phases)
    return total / count * 1e3 if count else None
