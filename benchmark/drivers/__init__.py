"""The general drivers, one per kind of traffic mix (a mix's `kind`)."""
