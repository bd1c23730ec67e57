"""Frame-index CLI parsing: "a:b" slices (with open ends) or "a,b,c" lists.

Copy of ``raynet_tpu/scripts/slicing.py``: ":" yields slice(None) so the
default selects every frame; a bare int yields a one-element list.
"""


def _int_or_none(x):
    try:
        return int(x)
    except ValueError:
        return None


def frame_idxs_type(arg):
    if ":" in arg:
        return slice(*[_int_or_none(v) for v in arg.split(":")])
    if "," in arg:
        return [int(v) for v in arg.split(",")]
    return [int(arg)]
