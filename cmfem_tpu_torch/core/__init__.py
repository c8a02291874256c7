from .reference_elements import ReferenceElement, get_reference_element
from .quadrature import QuadratureRule, gauss_rule
from .mesh import Mesh, load_gmsh, make_cartesian_mesh_2d, make_cartesian_mesh_3d
from .fespace import FESpace
from .geometry import GeometricFactors, compute_geometric_factors

__all__ = [
    "ReferenceElement",
    "get_reference_element",
    "QuadratureRule",
    "gauss_rule",
    "Mesh",
    "load_gmsh",
    "make_cartesian_mesh_2d",
    "make_cartesian_mesh_3d",
    "FESpace",
    "GeometricFactors",
    "compute_geometric_factors",
]
