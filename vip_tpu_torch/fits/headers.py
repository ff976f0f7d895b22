"""FITS header handling (port of ``vip_tpu.fits.headers``, a copy: the
port imports nothing of vip_tpu).

Implements a self-contained ``Header`` class (astropy is not a dependency
of this framework): an ordered case-insensitive mapping with FITS 80-char
card serialization/parsing, plus the conversion helpers of the reference.
"""

import numpy as np

__all__ = ["Header", "dict_to_fitsheader", "fitsheader_to_dict",
           "open_header", "seeing_from_header"]

BLOCK = 2880
CARD = 80


class Header:
    """Ordered, case-insensitive FITS header mapping with card I/O."""

    def __init__(self, cards=None):
        self._keys = []
        self._values = {}
        self._comments = {}
        self.comments_log = []
        self.history_log = []
        if cards:
            if isinstance(cards, Header):
                for k in cards.keys():
                    self[k] = cards[k]
            elif isinstance(cards, dict):
                for k, v in cards.items():
                    self[k] = v
            else:
                for k, v in cards:
                    self[k] = v

    # -- mapping protocol -------------------------------------------------
    def _norm(self, key):
        return str(key).strip().upper()

    def __setitem__(self, key, value):
        key = self._norm(key)
        if isinstance(value, tuple) and len(value) == 2:
            value, comment = value
            self._comments[key] = comment
        if key not in self._values:
            self._keys.append(key)
        self._values[key] = value

    def __getitem__(self, key):
        return self._values[self._norm(key)]

    def __delitem__(self, key):
        key = self._norm(key)
        del self._values[key]
        self._keys.remove(key)
        self._comments.pop(key, None)

    def __contains__(self, key):
        return self._norm(key) in self._values

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __eq__(self, other):
        if isinstance(other, (Header, dict)):
            return dict(self.items()) == dict(
                other.items() if hasattr(other, "items") else other)
        return NotImplemented

    def keys(self):
        return list(self._keys)

    def values(self):
        return [self._values[k] for k in self._keys]

    def items(self):
        return [(k, self._values[k]) for k in self._keys]

    def get(self, key, default=None):
        return self._values.get(self._norm(key), default)

    def update(self, other):
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v

    def copy(self):
        h = Header(self)
        h._comments = dict(self._comments)
        return h

    def add_history(self, text):
        self.history_log.append(str(text))

    def add_comment(self, text):
        self.comments_log.append(str(text))

    def __repr__(self):
        return "\n".join("{:8s}= {!r}".format(k, self._values[k])
                         for k in self._keys)

    # -- card serialization ------------------------------------------------
    @staticmethod
    def _format_value(value):
        if isinstance(value, (bool, np.bool_)):
            return "T" if value else "F"
        if isinstance(value, (int, np.integer)):
            return "{:>20d}".format(int(value))
        if isinstance(value, (float, np.floating)):
            s = "{:.16G}".format(float(value))
            if "." not in s and "E" not in s and "N" not in s:
                s += "."
            return "{:>20s}".format(s)
        s = str(value).replace("'", "''")
        return "'{:<8s}'".format(s)[:68]

    def tocards(self):
        """Serialize to a list of 80-char card strings (without END)."""
        cards = []
        for k in self._keys:
            v = self._values[k]
            comment = self._comments.get(k)
            if len(k) > 8 or " " in k:
                # HIERARCH convention for long keywords
                if v is None:
                    card = "HIERARCH {} =".format(k)
                else:
                    card = "HIERARCH {} = {}".format(
                        k, self._format_value(v).strip())
            elif v is None:
                card = "{:8s}".format(k)
            else:
                card = "{:8s}= {}".format(k, self._format_value(v))
            if comment:
                card += " / " + str(comment)
            cards.append(card[:CARD].ljust(CARD))
        for text in self.comments_log:
            cards.append(("COMMENT " + text)[:CARD].ljust(CARD))
        for text in self.history_log:
            cards.append(("HISTORY " + text)[:CARD].ljust(CARD))
        return cards

    @staticmethod
    def _parse_value(raw):
        raw = raw.strip()
        if raw.startswith("'"):
            end = raw.rfind("'")
            return raw[1:end].replace("''", "'").rstrip()
        if raw == "T":
            return True
        if raw == "F":
            return False
        try:
            if any(c in raw for c in ".EeDd") and not raw.lstrip("+-")\
                    .isdigit():
                return float(raw.replace("D", "E").replace("d", "e"))
            return int(raw)
        except ValueError:
            return raw

    @classmethod
    def fromcards(cls, cards):
        """Parse a list of 80-char cards (END excluded) into a Header."""
        h = cls()
        for card in cards:
            key = card[:8].strip()
            if not key:
                continue
            if key in ("COMMENT", "HISTORY"):
                text = card[8:].strip()
                if key == "COMMENT":
                    h.comments_log.append(text)
                else:
                    h.history_log.append(text)
                continue
            if key == "HIERARCH":
                body_full = card[9:]
                eq = body_full.find("= ")
                if eq < 0:
                    eq = body_full.find("=")
                    if eq < 0:
                        continue
                    key = body_full[:eq].strip()
                    h[key] = None
                    continue
                key = body_full[:eq].strip()
                body = body_full[eq + 2:]
                if body.lstrip().startswith("'"):
                    start = body.index("'")
                    end = body.index("'", start + 1)
                    while end + 1 < len(body) and body[end + 1] == "'":
                        end = body.index("'", end + 2)
                    h[key] = cls._parse_value(body[:end + 1])
                else:
                    slash = body.find("/")
                    h[key] = cls._parse_value(
                        body[:slash] if slash >= 0 else body)
                continue
            if card[8:10] != "= ":
                h[key] = None
                continue
            body = card[10:]
            # strip inline comment (outside of strings)
            if body.lstrip().startswith("'"):
                start = body.index("'")
                end = body.index("'", start + 1)
                while end + 1 < len(body) and body[end + 1] == "'":
                    end = body.index("'", end + 2)
                value_part = body[:end + 1]
                rest = body[end + 1:]
            else:
                slash = body.find("/")
                if slash >= 0:
                    value_part = body[:slash]
                    rest = body[slash:]
                else:
                    value_part = body
                    rest = ""
            h[key] = cls._parse_value(value_part)
            rest = rest.strip()
            if rest.startswith("/"):
                h._comments[h._norm(key)] = rest[1:].strip()
        return h


def dict_to_fitsheader(initial_dict):
    """Convert a dict to a Header (reference headers.py:19-37)."""
    fits_header = Header()
    for key, value in initial_dict.items():
        fits_header[key] = value
    return fits_header


def fitsheader_to_dict(initial_header, sort_by_prefix=""):
    """Extract a prefix-filtered parameter dict + algo name from a header
    (reference headers.py:40-77)."""
    head_dict = dict(initial_header.items())
    lowercase_dict = {key.lower(): value for key, value in head_dict.items()}
    parameters = {key[len(sort_by_prefix):]: value
                  for key, value in lowercase_dict.items()
                  if key.startswith(sort_by_prefix)}
    algo_name = parameters["algo_name"]
    del parameters["algo_name"]
    return parameters, algo_name


def open_header(fitsfilename, n=0, extname=None, verbose=False):
    """Load only the header of HDU ``n`` (reference headers.py:80-130)."""
    from .fits import _scan_hdus

    fitsfilename = str(fitsfilename)
    if not fitsfilename.endswith(".fits"):
        fitsfilename += ".fits"
    hdus = _scan_hdus(fitsfilename)
    if extname is not None:
        for hdu in hdus:
            if str(hdu["header"].get("EXTNAME", "")).lower() \
                    == extname.lower():
                return hdu["header"]
        raise KeyError("EXTNAME {} not found".format(extname))
    if verbose:
        print("Fits HDU-{} header successfully loaded.".format(n))
    return hdus[n]["header"]


def seeing_from_header(fitsfilename, verbose=False):
    """Mean DIMM seeing from an ESO-style header
    (reference headers.py:131-154)."""
    header = open_header(fitsfilename)
    start = header.get("HIERARCH ESO TEL AMBI FWHM START",
                       header.get("ESO TEL AMBI FWHM START"))
    end = header.get("HIERARCH ESO TEL AMBI FWHM END",
                     header.get("ESO TEL AMBI FWHM END"))
    if start is None or end is None:
        return None
    seeing = (float(start) + float(end)) / 2
    if verbose:
        print("Mean seeing: {}".format(seeing))
    return seeing
