"""Keyword checks shared by the references: each reference computes one
form of the full-frame PCA and refuses keywords it does not compute."""


def take(kwargs, defaults, allowed_values, ignored=("verbose", "fwhm")):
    """The keywords with ``defaults`` filled in; raises on a keyword the
    reference does not know or a value outside ``allowed_values``."""
    out = dict(defaults)
    for k, v in kwargs.items():
        if k in ignored:
            continue
        if k not in defaults:
            raise ValueError(f"the reference does not compute {k}={v!r}")
        out[k] = v
    for k, allowed in allowed_values.items():
        if out[k] not in allowed:
            raise ValueError(f"the reference does not compute {k}="
                             f"{out[k]!r} (only {allowed})")
    return out
