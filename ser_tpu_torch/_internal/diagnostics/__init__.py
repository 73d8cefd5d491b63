"""Doctor and startup preflight diagnostics."""
