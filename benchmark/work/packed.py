"""Bytes a combined-layout sort needs: every row (its key and every field)
read once and written once, whatever implements it."""


def bytes_needed(f: dict) -> int:
    return 2 * f["n"] * f["row_bytes"]
