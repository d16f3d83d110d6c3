"""Bytes a sort call needs: every row (key and payloads) read once and
written once, whatever the engine reads again."""


def bytes_needed(f: dict) -> int:
    return 2 * f["n"] * f["row_bytes"]
