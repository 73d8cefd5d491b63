"""Entry drivers, one per entry point of the port that a traffic mix drives, found by name."""
