from setuptools import find_packages, setup

setup(
    name="kge_tpu",
    version="0.1.0",
    description="TPU-native knowledge graph embedding framework (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests", "tests.*")),
    include_package_data=True,
    package_data={
        "kge_tpu": ["*.yaml", "models/*.yaml"],
        "kge_tpu_torch": ["*.yaml", "models/*.yaml", "csrc/*.cu",
                          "native/*.cpp"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "pyyaml",
        "optax",
    ],
    extras_require={
        "search": ["ax-platform"],
    },
    entry_points={"console_scripts": ["kge = kge_tpu.cli:main"]},
    zip_safe=False,
)
