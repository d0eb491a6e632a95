"""Package setup for hemx (the reference shipped a packaged release tarball,
releases/autoencoders-1.0.tar.gz; `python setup.py sdist` is the hemx
equivalent). Also builds the optional C++ data-loader extension."""

from __future__ import annotations

import os

from setuptools import Extension, find_packages, setup

ext_modules = []
if os.environ.get("HEMX_BUILD_NATIVE", "1") == "1":
    ext_modules.append(
        Extension(
            "hemx.data._native",
            sources=["hemx/native/tfrecord.cc"],
            extra_compile_args=["-O3", "-std=c++17"],
            optional=True,  # pure-python fallbacks exist everywhere
        ))

setup(
    name="hemx",
    version="0.1.0",
    description="TPU-native autoencoder/GAN research framework "
                "(JAX/XLA/Pallas rebuild of hem)",
    # hemx_torch: the PyTorch/CUDA port (needs the "torch" extra)
    packages=find_packages(include=["hemx", "hemx.*",
                                    "hemx_torch", "hemx_torch.*"]),
    # hemx.native.load() prefers the prebuilt hemx.data._native extension
    # (above); the source is shipped too so the build-on-demand path can
    # still work where the wheel's extension is absent.
    # hemx_torch.native has no prebuilt extension: it compiles its source
    # with g++ at first use (into hemx_torch/_build/native) and raises if
    # it cannot, so the source ships with the package; so does the CUDA
    # source of its input kernel, which nvcc compiles at first launch.
    package_data={"hemx.native": ["tfrecord.cc"],
                  "hemx_torch.native": ["tfrecord.cc"],
                  "hemx_torch": ["csrc/*.cu"]},
    py_modules=["train", "paper_train", "experimental", "visualize",
                "paper_metrics", "paper_fullimage", "paper_visualize",
                "events", "visualize_gui", "bench"],
    python_requires=">=3.10",
    install_requires=["jax", "optax", "flax", "numpy"],
    extras_require={"viz": ["matplotlib", "pillow"],
                    "torch": ["torch"]},
    ext_modules=ext_modules,
)
