"""Configuration and dtype policy."""
