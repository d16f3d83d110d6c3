"""Bytes a full-table ORDER BY needs: every row (each key column and each
payload) read once and written once, whatever implements it."""


def bytes_needed(f: dict) -> int:
    return 2 * f["n"] * f["row_bytes"]
