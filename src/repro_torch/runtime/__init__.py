"""Runtime services (`repro.runtime`): checkpoints and fault tolerance.
`runtime/elastic.py` (reshard on restore) is not ported: one card has no
mesh (ROADMAP Queue A 15)."""
