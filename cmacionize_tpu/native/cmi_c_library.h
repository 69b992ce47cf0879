/* C library API for cmacionize_tpu — the CMILibrary-compatible surface.
 *
 * Mirrors the reference's C ABI (/root/reference/src/CMILibrary.hpp:46-70,
 * /root/reference/c/cmi_c_library.h): a host simulation code initialises
 * the library once, then repeatedly hands over SPH particle arrays and
 * receives per-particle hydrogen neutral fractions.  The implementation
 * (cmi_c_library.c) embeds a CPython interpreter and dispatches into the
 * cmacionize_tpu.cmi module, so the full JAX compute path runs behind
 * a plain C ABI.
 *
 * Build (see cmacionize_tpu/native/__init__.py:build_cmi):
 *   gcc -shared -fPIC cmi_c_library.c $(python3-config --includes) \
 *       $(python3-config --ldflags --embed) -o libcmi_tpu.so
 */

#ifndef CMI_C_LIBRARY_H
#define CMI_C_LIBRARY_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Initialise: load the parameter file; units convert the caller's length/
 * mass values to SI.  mapping_type: "M over V", "centroid" or "Petkova".
 * talk != 0 enables status logging.  num_thread is accepted for API
 * compatibility (XLA manages its own threading). */
void cmi_init(const char *parameter_file, int num_thread,
              double unit_length_in_SI, double unit_mass_in_SI,
              const char *mapping_type, int talk);

/* Periodic variants: box_anchor/box_sides (length 3, caller units)
 * override the parameter file's SimulationBox. */
void cmi_init_periodic_dp(const char *parameter_file, int num_thread,
                          double unit_length_in_SI, double unit_mass_in_SI,
                          const double *box_anchor, const double *box_sides,
                          const char *mapping_type, int talk);
void cmi_init_periodic_sp(const char *parameter_file, int num_thread,
                          double unit_length_in_SI, double unit_mass_in_SI,
                          const float *box_anchor, const float *box_sides,
                          const char *mapping_type, int talk);

/* Free the library state. */
void cmi_destroy(void);

/* Compute per-particle neutral fractions.  dp: all double; sp: all float;
 * mp: double positions, float smoothing lengths/masses/output. */
void cmi_compute_neutral_fraction_dp(const double *x, const double *y,
                                     const double *z, const double *h,
                                     const double *m, double *nH, size_t N);
void cmi_compute_neutral_fraction_sp(const float *x, const float *y,
                                     const float *z, const float *h,
                                     const float *m, float *nH, size_t N);
void cmi_compute_neutral_fraction_mp(const double *x, const double *y,
                                     const double *z, const float *h,
                                     const float *m, float *nH, size_t N);

#ifdef __cplusplus
}
#endif

#endif /* CMI_C_LIBRARY_H */
