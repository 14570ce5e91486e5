"""The dataset inputs the port builds: the SCN backbone's (voxel
coordinates and all-ones features). SPVCNN's sparse-quantized and
SalsaNext's range-image inputs and the depth labels wait for ROADMAP M14."""


def check_scn_inputs(backbone: str = "SCN", with_depth_label: bool = False,
                     use_sparse_quantize: bool = False) -> None:
    """Raise ``NotImplementedError`` naming M14 for inputs not ported yet."""
    what = []
    if str(backbone).upper().startswith("SPVCNN") or backbone == "SalsaNext":
        what.append("the {} inputs".format(backbone))
    if use_sparse_quantize:
        what.append("use_sparse_quantize")
    if with_depth_label:
        what.append("with_depth_label")
    if what:
        raise NotImplementedError("not ported yet (ROADMAP M14): {}".format(
            ", ".join(what)))
