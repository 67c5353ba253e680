"""Host layouts (`mesh/`, `io/mesh_reader.py`,
`model.py::SeaIceModel.__init__`): the harness's clock around the mesh's
read or generation and reordering and the model's build, in seconds."""


def read(ctx):
    return ctx.extra.get("layout_s")
