"""Material kinds of the configurations' scenes, one module a kind that a
configuration's material names (`"kind": <kind>`), found by that name:
`make(spec)` returns the renderer's material. Its plain reference is
portbench/reference/materials/<kind>.py."""
