"""Public runtime contracts and versioned output schema."""
