"""The general entries for the kinds of work a traffic mix names in its ``entry``."""
