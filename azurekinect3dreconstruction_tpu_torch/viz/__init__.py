"""Host-side visualization and persistence: PLY/OBJ writers and readers,
PNG previews, the HTML export, the live browser viewer, the optional
Open3D bridge and the saved-result browsers."""

from azurekinect3dreconstruction_tpu_torch.viz.browsers import (
    ReconstructionBrowser,
    list_results,
    load_latest_mesh,
    load_latest_reconstruction,
)
from azurekinect3dreconstruction_tpu_torch.viz.html_export import save_html_viewer
from azurekinect3dreconstruction_tpu_torch.viz.live_server import (
    BrowserLiveViewer,
    LiveViewerServer,
)
from azurekinect3dreconstruction_tpu_torch.viz.o3d_bridge import LiveViewer, view_geometry
from azurekinect3dreconstruction_tpu_torch.viz.savers import (
    ResultSaver,
    read_geometry,
    read_obj,
    read_ply,
    write_obj_mesh,
    write_ply_mesh,
    write_ply_point_cloud,
)
