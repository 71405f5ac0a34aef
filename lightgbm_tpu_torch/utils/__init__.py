"""Host helpers shared by the port's modules."""


def coerce_bool(value) -> bool:
    """The bool-coercion rule of config params (CLI spellings)."""
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)):
        return bool(value)
    return str(value).strip().lower() in ("true", "1", "yes", "y", "t", "+")
