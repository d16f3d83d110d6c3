"""Bytes a `filter_rows` call needs: the mask read once (one byte a row),
and each selected row's bytes, in every stream at its own width, read once
and written once.  Rows left out need not move."""


def bytes_needed(f: dict) -> int:
    return f["n"] + 2 * f["selected"] * sum(f["stream_bytes"])
