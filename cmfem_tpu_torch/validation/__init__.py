"""Code-to-code validation harnesses and plotters (copy of
``cmfem_tpu/validation``, which cannot be imported without JAX): the
drivers' CSVs against FIAT (case 1), Amaryllis (cases 2.1/2.2) and the Q*
analytic profile, the material-deck generator, and the plotters.  numpy
only; matplotlib is imported inside the functions that draw."""
