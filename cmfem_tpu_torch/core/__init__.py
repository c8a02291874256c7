from .reference_elements import ReferenceElement, get_reference_element
from .quadrature import QuadratureRule, gauss_rule
from .mesh import (
    Mesh, load_gmsh, write_gmsh, make_cartesian_mesh_2d, make_cartesian_mesh_3d,
    make_strip_mesh_2d, make_tet_mesh,
)
from .fespace import FESpace
from .geometry import (
    GeometricFactors,
    FaceFactors,
    compute_geometric_factors,
    compute_face_factors,
    factors_for,
)

__all__ = [
    "ReferenceElement",
    "get_reference_element",
    "QuadratureRule",
    "gauss_rule",
    "Mesh",
    "load_gmsh",
    "write_gmsh",
    "make_cartesian_mesh_2d",
    "make_cartesian_mesh_3d",
    "make_strip_mesh_2d",
    "make_tet_mesh",
    "FESpace",
    "GeometricFactors",
    "compute_geometric_factors",
    "FaceFactors",
    "compute_face_factors",
    "factors_for",
]
