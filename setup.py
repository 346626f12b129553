"""Package metadata for the cloud-tpu framework.

Parity with the reference's packaging (reference src/python/setup.py:
33-68): same single-package layout and dependency split, with the
TPU-native stack in place of TF. Like the reference, a pinned Vizier
discovery document ships inside the package (reference
tuner/constants.py:20-22) as the offline fallback for
cloud_tpu/tuner/optimizer_client.py:build_service_client."""

import os

from setuptools import find_packages, setup

import dependencies


def _version():
    context = {}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "cloud_tpu", "version.py")) as f:
        exec(f.read(), context)
    return context["__version__"]


setup(
    name="cloud-tpu-framework",
    version=_version(),
    description=("A TPU-native framework for training models on Google "
                 "Cloud: launch, tune, and fit JAX models on TPU slices "
                 "and pods."),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["cloud_tpu", "cloud_tpu.*",
                                    "cloud_tpu_torch", "cloud_tpu_torch.*"]),
    package_data={"cloud_tpu.tuner": ["api/*.json"],
                  "cloud_tpu_torch.ops": ["csrc/*.cu"]},
    python_requires=">=3.9",
    install_requires=dependencies.make_required_install_packages(),
    extras_require=dependencies.make_required_extra_packages(),
    classifiers=[
        "Development Status :: 3 - Alpha",
        "Intended Audience :: Developers",
        "Programming Language :: Python :: 3",
        "Topic :: Scientific/Engineering :: Artificial Intelligence",
    ],
)
