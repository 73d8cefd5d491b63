"""General CLI output helpers (copied from ``ser_tpu/_internal/utils/common.py``)."""


def display_elapsed_time(elapsed_time: float, _format: str = "long") -> str:
    """Formats elapsed seconds as verbose ("long") or compact ("short") text."""
    minutes, seconds = divmod(int(elapsed_time), 60)
    if _format == "long":
        return f"{minutes} min {seconds} seconds" if minutes else f"{elapsed_time:.2f} seconds"
    return f"{minutes}m{seconds}s" if minutes else f"{elapsed_time:.2f}s"


__all__ = ["display_elapsed_time"]
