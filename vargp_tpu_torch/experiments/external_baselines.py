"""External baseline curves for the method comparisons.

The port's own copy of ``vargp_tpu/experiments/external_baselines.py``
(importing that module would import the JAX package).  The reference
notebooks (mnist.ipynb cells 6/15/19/24) overlay VCL and VCL-coreset
average-accuracy curves on VAR-GP's; their CSV artifacts upstream are
git-LFS stubs and the reference has no VCL implementation, so the curves
are constants here, as they are in the JAX package.

PROVENANCE AND PRECISION: approximate digitizations of the published
figures of arXiv:2006.05468 (Kapoor, Karaletsos, Bui, "Variational
Auto-Regressive Gaussian Processes for Continual Learning"), Fig. 2(a)
(Split-MNIST) and the Permuted-MNIST comparison figure, single-head
evaluation, VCL variants with coresets per the paper's legend; good to
roughly +/-0.01-0.02 absolute accuracy, for overlay figures only, never
for parity assertions.  ``PROVENANCE`` goes into every written JSON.
"""

# avg test accuracy over tasks seen so far, after each task (index = task)
VCL_SMNIST = {
    # single-head VCL degrades hard on Split-MNIST; coresets recover some
    "vcl_100_coreset_100": [0.99, 0.90, 0.80, 0.72, 0.62],
    "vcl_100_100_coreset_100": [0.99, 0.92, 0.84, 0.76, 0.67],
}

VCL_PMNIST = {
    # permutations keep the label space fixed, so VCL holds up far better
    "vcl_100_coreset_100": [0.96, 0.95, 0.94, 0.94, 0.93,
                            0.93, 0.92, 0.92, 0.91, 0.91],
    "vcl_100_100_coreset_100": [0.97, 0.96, 0.96, 0.95, 0.95,
                                0.94, 0.94, 0.93, 0.93, 0.93],
}

PROVENANCE = (
    "approximate digitization of arXiv:2006.05468 figures "
    "(Split-MNIST Fig. 2a / Permuted-MNIST comparison; single-head "
    "evaluation); +/-0.01-0.02 absolute — overlay use only, upstream's "
    "own CSV artifacts are git-LFS stubs (notebooks/results/*.csv)"
)
