"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding is validated on host CPU devices
(xla_force_host_platform_device_count); the tests never need a GPU.
The fused event bodies run as plain XLA here, as they do on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

from skirt_tpu.cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# persistent XLA compile cache: the quick tier is compile-dominated on
# the CPU, so repeat runs reuse what earlier runs compiled
enable_compile_cache()


# ---------------------------------------------------------------------------
# Quick-tier split: the heaviest tests are marked slow here (single list
# instead of scattering decorators), so
#   pytest -m "not slow"    pre-commit tier (measured 2026-08-22:
#                           224 s cold, 143 s warm via the persistent
#                           compile cache above — repeat runs are the
#                           pre-commit case)
#   pytest                  full physics suite
# Durations measured 2026-08-22 (pytest --durations=60).
# ---------------------------------------------------------------------------

_SLOW_TESTS = {
    ("test_pan.py", "test_table_energy_conservation_and_leaf_resolution"),
    ("test_pan.py", "test_table_matches_leaf_walk"),
    ("test_poly.py", "test_refill_normalization"),
    ("test_poly.py", "test_matches_mono_direct"),
    ("test_fused_table.py", "test_two_component_refill"),
    ("test_migrate.py", "test_parity_vs_single_device"),
    ("test_golden.py", "test_reference_exact_outputs_pinned"),
    ("test_fused.py", "test_refill_with_lam_inputs"),
    ("test_polarization_multi.py", "test_mixed_polarized_unpolarized_runs"),
    ("test_analytic_mode.py", "test_sampled_deposition_unbiased"),
    ("test_geometry.py", "test_trust6_quadrature_normalized"),
    ("test_cartesian_traversal.py", "test_chord_length_equals_sum_ds"),
    ("test_cartesian_traversal.py", "test_cells_visited_once"),
    ("test_fused_table.py", "test_exact_peel_attenuation_sphere"),
    ("test_grains.py", "test_large_grain_matches_equilibrium"),
    ("test_fit.py", "test_fitskirt_main_runs_batch"),
    ("test_migrate.py", "test_d8_matches_d1"),
    ("test_checkpoint.py", "test_kill_resume_bitwise"),
    ("test_voronoi.py", "test_error_measured_and_refusal"),
    ("test_voronoi.py", "test_error_decreases_with_resolution"),
    ("test_fused_table.py", "test_exact_peel_matches_fine_staged"),
    ("test_polarization_multi.py",
     "test_zero_opacity_second_component_is_noop"),
    ("test_fused.py", "test_128_lambda_parity"),
    ("test_imports.py", "test_voronoi_stellar_components"),
    ("test_cartesian_traversal.py", "test_propagate_matches_optical_depth"),
    ("test_analytic_mode.py", "test_sphere1d_matches_cartesian"),
    ("test_analytic_mode.py", "test_sphere2d_matches_cartesian"),
    ("test_voronoi.py", "test_lifecycle_analytic_vs_gridded"),
    ("test_compaction.py", "test_matches_discrete_peeloff"),
    ("test_compaction.py", "test_scattering_statistically_consistent"),
    ("test_compaction.py", "test_absorbed_energy_matches"),
    ("test_compaction.py", "test_matches_exact_within_cell_scale"),
    ("test_compaction.py", "test_pure_absorption_identical"),
    ("test_ski_pan.py", "test_pan_ski_runs_with_spherical_grid"),
    ("test_cross_grid.py", "test_torus_obscuration_consistent_across_grids"),
    ("test_pan.py", "test_matches_gridded"),
    ("test_pan.py", "test_self_absorption_converges_grey_dust"),
    ("test_pan.py", "test_energy_conservation_with_reemission"),
    ("test_pan.py", "test_fused_pan_energy_conservation"),
    ("test_pan.py", "test_energy_conservation_analytic_sampled"),
    ("test_pan.py", "test_two_component_energy_conservation"),
    ("test_pan_transient.py", "test_transient_pan_runs_and_adds_mid_ir"),
    ("test_checkpoint.py", "test_dim1_matches_allcells"),
    ("test_checkpoint.py", "test_resume_reproduces_full_run"),
    ("test_checkpoint.py", "test_dim2_library_runs"),
    ("test_discover.py", "test_foam_decorator_samples_clumpy"),
    ("test_voxelize.py", "test_table_tau_converges_to_exact"),
    ("test_voxelize.py", "test_driver_auto_voxelize"),
    ("test_voxelize.py", "test_not_auto_engaged_but_opt_in_works"),
    ("test_voxelize.py", "test_sed_and_labs_match_leaf_walk"),
    ("test_voxelize.py", "test_driver_table_opt_in"),
    ("test_voxelize.py", "test_table_matches_gridded_voxel_walk"),
    ("test_geometry.py", "test_clumpy_mass_split"),
    ("test_slab.py", "test_analytic_mode_parity"),
    ("test_slab.py", "test_two_components"),
    ("test_slab.py", "test_single_component"),
    ("test_slab.py", "test_pure_absorption_physics"),
    ("test_slab.py", "test_labs_is_sharded"),
    ("test_slab.py", "test_oligo_simulation_use_mesh_slab"),
    ("test_slab.py", "test_table_mode_parity"),
    ("test_slab.py", "test_table_matches_gridded_slab"),
    ("test_parallel.py", "test_matches_single_device"),
    ("test_parallel.py", "test_matches_replicated"),
    ("test_parallel.py", "test_rays_parallel_to_slab_planes"),
    ("test_curved_grids.py", "test_optical_depth_theta_structure"),
    ("test_curved_grids.py", "test_chord_and_volumes"),
    ("test_fused.py", "test_sed_matches"),
    ("test_fused.py", "test_octree_sed_matches_unfused"),
    ("test_fused.py", "test_refill_normalization_and_parity"),
    ("test_lifecycle.py", "test_absorption_energy_balance"),
    ("test_lifecycle.py", "test_energy_conservation_with_scattering"),
    ("test_lifecycle.py", "test_equals_sequential"),
    ("test_lifecycle.py", "test_modes_agree"),
    ("test_lifecycle.py", "test_matches_independent_instruments"),
    ("test_lifecycle.py", "test_pure_scattering_sphere_conserves_flux"),
    ("test_isrf.py", "test_uniform_sphere_tau_map"),
    ("test_octree.py", "test_optical_depth_matches_cartesian"),
    ("test_ski.py", "test_cli_emulate"),
    ("test_ski.py", "test_load_and_run"),
    ("test_ski.py", "test_fast_engages_table_and_agrees"),
    ("test_imports.py", "test_voronoi_distribution_reuses_mesh"),
    ("test_fit.py", "test_fski_fit_runs"),
    ("test_analytic_mode.py", "test_converges_to_gridded"),
    ("test_analytic_mode.py", "test_matches_standard"),
    ("test_polarization.py", "test_scattered_light_polarized"),
    # -- round-5 re-split (durations measured 2026-08-22): the heaviest
    # tests move here; every feature keeps at least one quick test
    # (slab-fused: parity class; pan-poly: analytic energy conservation;
    # poly: table fixture + wide-W; polarization: both parity tests;
    # migrate: dust-phase parity; multi-component: fused analytic class)
    ("test_slab_fused.py", "test_refill_matches_plain"),
    ("test_pan.py", "test_poly_matches_mono_pan"),
    ("test_pan.py", "test_multicomponent_poly_pan_conserves"),
    ("test_pan.py", "test_table_poly_conserves_energy"),
    ("test_fused_table.py", "test_two_component_parity"),
    ("test_fused_table.py", "test_refill_normalization"),
    ("test_polarization.py", "test_fused_polarized_refill"),
    ("test_polarization.py", "test_table_polarized_refill"),
    ("test_migrate.py", "test_anisotropic_stellar_emission_peel"),
    ("test_fused.py", "test_17_lambda_uses_lam_inputs"),
    ("test_octree.py", "test_matches_redescend_octree"),
    ("test_octree.py", "test_matches_redescend_bintree_barycentric"),
    ("test_octree.py", "test_leaf_occupancy_and_chords"),
    ("test_octree.py", "test_chord_sums"),
    ("test_octree.py", "test_build_and_field_coverage"),
    ("test_analytic_mode.py", "test_cylinder2d_matches_cartesian"),
    ("test_analytic_mode.py", "test_octree_matches_cartesian"),
    ("test_analytic_mode.py", "test_matches_host_density"),
    ("test_poly.py", "test_matches_mono_fused"),
    ("test_cartesian_traversal.py", "test_optical_depth_uniform_medium"),
    ("test_cartesian_traversal.py", "test_optical_depth_nonuniform"),
    ("test_cartesian_traversal.py", "test_propagate_to_tau"),
    ("test_grains.py", "test_small_grain_shows_stochastic_excess"),
    ("test_curved_grids.py", "test_matches_cartesian_optical_depth"),
    ("test_curved_grids.py", "test_chord_through_cylinder"),
    ("test_curved_grids.py", "test_ray_through_axis"),
    ("test_imports.py", "test_sph_distribution_with_particle_tree"),
    ("test_imports.py", "test_driver_write_grid"),
    ("test_voronoi.py", "test_in_cell_sampling"),
    ("test_lifecycle.py", "test_escape_fraction"),
    ("test_parallel.py", "test_tallies_are_replicated_sum"),
    ("test_parallel.py",
     "test_simulation_uses_mesh_and_matches_physics"),
    ("test_geometry.py", "test_all_normalized_and_sampling_matches"),
    ("test_geometry.py", "test_spherical_cavity"),
    ("test_analytic_mode.py", "test_energy_conservation"),
    ("test_benchmarks.py", "test_gridded_matches_exact_too"),
    ("test_ski.py", "test_fast_pan_rides_table_with_leaf_emission"),
}


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        base = item.fspath.basename
        name = getattr(item, "originalname", None) or item.name
        if (base, name.split("[")[0]) in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
