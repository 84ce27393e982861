"""Split format: reader, synthetic generator and impact ordering."""
