"""Shape kinds of the configurations' scenes, one module a kind, each with
`build(spec, material_ids) -> list of portbench.scene.Mesh`."""
