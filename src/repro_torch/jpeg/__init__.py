"""JPEG substrate: format parsing, coding tables, reference codec (numpy)."""
