"""SPICE-style number parsing with decimal prefixes.

Behavioral equivalent of the reference's ``numeric`` string-to-float routine
(utilites.f90:343-475): decimal prefixes f/p/n/u/m/c/h/k/meg/g/t/pet, the
"infix prefix as decimal point" convention (``1k3`` == 1.3e3), comma as
decimal point, and silent fallback to 0.0 on garbage (the Fortran list-
directed READ behavior for empty/invalid strings).
"""

from __future__ import annotations

_SINGLE = {
    "K": 1e3,
    "U": 1e-6,
    "N": 1e-9,
    "G": 1e9,
    "T": 1e12,
    "F": 1e-15,
    "C": 1e-2,
    "H": 1e2,
}

# Search order matches the reference (utilites.f90:374, 389-435):
# M,K,U,N,P,G,T,F,C,H; 'MEG' overrides 'M', 'PET' overrides 'P'.
_ORDER = "MKUNPGTFCH"

_KEEP = set("0123456789.-")


def spice_to_float(text: str) -> float:
    """Parse a SPICE-prefixed number string into a float.

    Examples: ``"100m" -> 0.1``, ``"5m" -> 5e-3``, ``"1k3" -> 1300.0``,
    ``"2meg" -> 2e6``, ``"1e-3" -> 1e-3``, ``"-0.95" -> -0.95``.
    Returns 0.0 when no number can be extracted (matches the reference's
    behavior for strings like ``"t"``).
    """
    s = text.strip().upper()
    if not s:
        return 0.0
    s = s.replace(",", ".", 1)

    mult = 1.0
    pos = -1
    triple = 0  # length-3 prefix position ('MEG'/'PET'), else -1
    tri_at = -1
    for p in _ORDER:
        idx = s.find(p)
        if idx < 0:
            continue
        if p == "M":
            tri_at = s.find("MEG")
            if tri_at >= 0:
                mult, triple = 1e6, 3
            else:
                mult = 1e-3
        elif p == "P":
            tri_at = s.find("PET")
            if tri_at >= 0:
                mult, triple = 1e15, 3
            else:
                mult = 1e-12
        else:
            mult = _SINGLE[p]
        pos = idx
        break

    if pos >= 0:
        if "." not in s:
            # Prefix doubles as the decimal point: 1k3 -> 1.3 (then *1e3).
            s = s[:pos] + "." + s[pos + 1 :]
            if triple:
                # 'MEG'/'PET': the '.' replaced the first char; drop the rest.
                s = s[: tri_at + 1] + s[tri_at + 3 :]
        elif triple:
            s = s[:tri_at] + s[tri_at + 3 :]

    if "E" not in s:
        s = "".join(c if c in _KEEP else " " for c in s)
        s = s.replace(" ", "")
    else:
        # Scientific form: strip a leftover single-char prefix if present
        # before/after the mantissa (reference leaves it and READ tolerates
        # trailing blanks; we remove non-number chars conservatively).
        s = "".join(c for c in s if c in _KEEP or c in "E+")

    try:
        value = float(s)
    except ValueError:
        return 0.0
    return mult * value
