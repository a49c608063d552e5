"""Core pieces the port shares across its ops: the mixed-precision policy
(:mod:`.amp`)."""
