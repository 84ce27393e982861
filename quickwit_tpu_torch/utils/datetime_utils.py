"""Datetime parsing/formatting.

Role of the reference's `quickwit-datetime` crate: parse input datetime values
in several formats (RFC3339, unix timestamps at several resolutions, strptime
patterns) into a single index representation. We store **microseconds since
unix epoch (i64)**, matching the reference's `DateTime` precision ladder.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Union

_RFC3339_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})[Tt ](\d{2}):(\d{2}):(\d{2})(\.\d+)?"
    r"(?:([Zz])|([+-]\d{2}):?(\d{2}))?$"
)
_DATE_RE = re.compile(r"^(\d{4})[-/](\d{2})[-/](\d{2})$")

MICROS = 1_000_000


def _unix_number_to_micros(value: float) -> int:
    """Heuristic resolution detection for numeric timestamps.

    Mirrors the reference's `unix_timestamp` coercion: seconds, millis,
    micros, or nanos chosen by magnitude.
    """
    v = abs(value)
    if v < 10_000_000_000:  # seconds (until year ~2286)
        return int(round(value * MICROS))
    if v < 10_000_000_000_000:  # millis
        return int(round(value * 1_000))
    if v < 10_000_000_000_000_000:  # micros
        return int(round(value))
    return int(round(value / 1_000))  # nanos


def parse_datetime_to_micros(
    value: Union[str, int, float],
    input_formats: tuple[str, ...] = ("rfc3339", "unix_timestamp"),
) -> int:
    """Parse per the configured input formats, first match wins."""
    for fmt in input_formats:
        try:
            if fmt == "unix_timestamp":
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    return _unix_number_to_micros(value)
                if isinstance(value, str) and re.fullmatch(r"-?\d+", value):
                    # query-string bounds arrive as strings
                    # (reference: `ts:>=1684993002`)
                    return _unix_number_to_micros(int(value))
                continue
            if fmt in ("rfc3339", "iso8601"):
                if not isinstance(value, str):
                    continue
                micros = _parse_rfc3339(value)
                if micros is not None:
                    return micros
                continue
            # strptime pattern
            if isinstance(value, str):
                dt = _dt.datetime.strptime(value, fmt)
                if dt.tzinfo is None:
                    dt = dt.replace(tzinfo=_dt.timezone.utc)
                return int(dt.timestamp() * MICROS)
        except (ValueError, OverflowError):
            continue
    raise ValueError(f"cannot parse datetime {value!r} with formats {input_formats}")


def _parse_rfc3339(text: str) -> int | None:
    m = _RFC3339_RE.match(text.strip())
    if m is None:
        dm = _DATE_RE.match(text.strip())
        if dm is None:
            return None
        dt = _dt.datetime(int(dm[1]), int(dm[2]), int(dm[3]), tzinfo=_dt.timezone.utc)
        return int(dt.timestamp() * MICROS)
    frac = m.group(7)
    micros_frac = int(round(float(frac) * MICROS)) if frac else 0
    if m.group(8):  # Z
        offset = _dt.timezone.utc
    elif m.group(9):
        sign = 1 if m.group(9).startswith("+") else -1
        hours = int(m.group(9)[1:])
        minutes = int(m.group(10))
        offset = _dt.timezone(sign * _dt.timedelta(hours=hours, minutes=minutes))
    else:
        offset = _dt.timezone.utc
    dt = _dt.datetime(
        int(m[1]), int(m[2]), int(m[3]), int(m[4]), int(m[5]), int(m[6]), tzinfo=offset
    )
    return int(dt.timestamp()) * MICROS + micros_frac


def format_micros_rfc3339(micros: int) -> str:
    dt = _dt.datetime.fromtimestamp(micros / MICROS, tz=_dt.timezone.utc)
    if micros % MICROS == 0:
        # reference Rfc3339 output drops zero subseconds
        return dt.strftime("%Y-%m-%dT%H:%M:%S") + "Z"
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"


def truncate_to_precision(micros: int, precision: "str | None") -> int:
    """Truncate microseconds to a fast-column precision (reference
    `fast_precision`): both stored values and range bounds truncate, so
    sub-precision range bounds behave exactly like the reference."""
    if precision == "seconds":
        return (micros // 1_000_000) * 1_000_000
    if precision == "milliseconds":
        return (micros // 1_000) * 1_000
    return micros


_JAVA_TIME_TOKENS = [
    ("yyyy", "%Y"), ("MM", "%m"), ("dd", "%d"), ("HH", "%H"),
    ("mm", "%M"), ("ss", "%S"), ("SSSSSS", "%f"), ("SSS", "%f"),
]


def parse_java_time_format(pattern: str, text: str) -> int:
    """Parse `text` with an ES/java-time `format` pattern (range queries'
    `format` param; reference: quickwit-datetime's java-time support).
    Supports the yyyy/MM/dd/HH/mm/ss/SSS[SSS] tokens and quoted literals."""
    import datetime as _dt
    fmt = ""
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "'":
            end = pattern.find("'", i + 1)
            if end == -1:
                raise ValueError(f"unterminated quote in format {pattern!r}")
            fmt += pattern[i + 1: end].replace("%", "%%")
            i = end + 1
            continue
        for token, directive in _JAVA_TIME_TOKENS:
            if pattern.startswith(token, i):
                fmt += directive
                i += len(token)
                break
        else:
            fmt += ch.replace("%", "%%")
            i += 1
    parsed = _dt.datetime.strptime(text, fmt).replace(
        tzinfo=_dt.timezone.utc)
    return int(parsed.timestamp()) * 1_000_000 + parsed.microsecond
