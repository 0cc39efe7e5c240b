"""K1, the MSAA face selection (hifihr_tpu_torch/render/raster_msaa.py,
csrc/raster_msaa.cu): one route a call, a zero fill of the per-tile face
bitmasks (a memset) right before `msaa_bin_kernel`, then
`msaa_fine_kernel<samples>`.

A call is seen at the renderer's `select_faces`, which keeps its scene (the
posed mesh and the camera) by reference. Its least time is K1's work on that
scene, worked out again by the reference's own projection and preparation
(roofline.k1_bound_s): the faces' records and boxes read, face id, coverage
and depth written, and the operations of every (pixel, face) pair whose box
touches the pixel."""

from benchmark import roofline

# the port's function whose calls are this kernel's: (module, attribute path)
WRAPS = ("hifihr_tpu_torch.render.renderer", "PhongRenderer.select_faces")
# a call's kernels in the trace, each with the operations counted with it
# where one of these runs right before it
TRACE = (("msaa_bin_kernel", ("Memset",)), ("msaa_fine_kernel", ()))


def record(renderer, verts_cam, K):
    """What a call keeps: references to its scene, nothing copied."""
    s = renderer.settings
    return verts_cam.detach(), K, renderer.faces, s.image_size, s.aa_factor


def bound_s(call) -> float:
    from benchmark.reference.render.raster import project_to_screen
    from benchmark.reference.render.raster_msaa import msaa_prep

    verts, K, faces, size, samples = call
    return roofline.k1_bound_s(msaa_prep(project_to_screen(verts, K), faces)[1], size, samples)
