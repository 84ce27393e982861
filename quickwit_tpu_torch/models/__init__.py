"""Doc mapping."""
