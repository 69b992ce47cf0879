/* C ABI shim for the cmacionize_tpu library API.
 *
 * Embeds a CPython interpreter (initialised lazily on the first cmi_init)
 * and forwards every call into cmacionize_tpu.cmi — the C surface of the
 * reference's CMILibrary (/root/reference/src/CMILibrary.cpp:46-95),
 * backed by the JAX compute path instead of the C++ simulation.
 * Particle buffers cross the boundary zero-copy as memoryviews.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdio.h>

#include "cmi_c_library.h"

static PyObject *cmi_module = NULL;
static int we_initialized_python = 0;

static int ensure_python(void) {
  if (cmi_module != NULL)
    return 0;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized_python = 1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  cmi_module = PyImport_ImportModule("cmacionize_tpu.cmi");
  if (cmi_module == NULL) {
    PyErr_Print();
    fprintf(stderr, "cmi: failed to import cmacionize_tpu.cmi "
                    "(is the package on PYTHONPATH?)\n");
  }
  PyGILState_Release(gil);
  return cmi_module == NULL ? -1 : 0;
}

static void call_init(const char *parameter_file, double unit_length_in_SI,
                      double unit_mass_in_SI, const char *mapping_type,
                      int talk, const double *box_anchor,
                      const double *box_sides, int periodic) {
  if (ensure_python() != 0)
    return;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *kwargs = Py_BuildValue(
      "{s:s, s:d, s:d, s:s, s:i, s:i}", "parameter_file", parameter_file,
      "unit_length_in_SI", unit_length_in_SI, "unit_mass_in_SI",
      unit_mass_in_SI, "mapping_type", mapping_type, "talk", talk, "periodic",
      periodic);
  if (box_anchor != NULL) {
    PyObject *anchor = Py_BuildValue("(d,d,d)", box_anchor[0], box_anchor[1],
                                     box_anchor[2]);
    PyObject *sides =
        Py_BuildValue("(d,d,d)", box_sides[0], box_sides[1], box_sides[2]);
    PyDict_SetItemString(kwargs, "box_anchor", anchor);
    PyDict_SetItemString(kwargs, "box_sides", sides);
    Py_XDECREF(anchor);
    Py_XDECREF(sides);
  }
  PyObject *fn = PyObject_GetAttrString(cmi_module, "cmi_init");
  PyObject *empty = PyTuple_New(0);
  PyObject *result = PyObject_Call(fn, empty, kwargs);
  if (result == NULL)
    PyErr_Print();
  Py_XDECREF(result);
  Py_XDECREF(empty);
  Py_XDECREF(fn);
  Py_XDECREF(kwargs);
  PyGILState_Release(gil);
}

void cmi_init(const char *parameter_file, int num_thread,
              double unit_length_in_SI, double unit_mass_in_SI,
              const char *mapping_type, int talk) {
  (void)num_thread;
  call_init(parameter_file, unit_length_in_SI, unit_mass_in_SI, mapping_type,
            talk, NULL, NULL, 0);
}

void cmi_init_periodic_dp(const char *parameter_file, int num_thread,
                          double unit_length_in_SI, double unit_mass_in_SI,
                          const double *box_anchor, const double *box_sides,
                          const char *mapping_type, int talk) {
  (void)num_thread;
  call_init(parameter_file, unit_length_in_SI, unit_mass_in_SI, mapping_type,
            talk, box_anchor, box_sides, 1);
}

void cmi_init_periodic_sp(const char *parameter_file, int num_thread,
                          double unit_length_in_SI, double unit_mass_in_SI,
                          const float *box_anchor, const float *box_sides,
                          const char *mapping_type, int talk) {
  double anchor[3] = {box_anchor[0], box_anchor[1], box_anchor[2]};
  double sides[3] = {box_sides[0], box_sides[1], box_sides[2]};
  (void)num_thread;
  call_init(parameter_file, unit_length_in_SI, unit_mass_in_SI, mapping_type,
            talk, anchor, sides, 1);
}

void cmi_destroy(void) {
  if (cmi_module == NULL)
    return;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *result = PyObject_CallMethod(cmi_module, "cmi_destroy", NULL);
  if (result == NULL)
    PyErr_Print();
  Py_XDECREF(result);
  PyGILState_Release(gil);
  /* the interpreter stays alive: JAX runtimes do not survive
   * Py_Finalize/re-Init cycles, and a host code may re-init the library */
}

/* in_size/h_size: element sizes of the position and h/m/out buffers. */
static void call_compute(const void *x, const void *y, const void *z,
                         const void *h, const void *m, void *nH, size_t N,
                         const char *in_dtype, const char *h_dtype) {
  if (ensure_python() != 0)
    return;
  size_t in_size = in_dtype[1] == '8' ? 8 : 4;
  size_t h_size = h_dtype[1] == '8' ? 8 : 4;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject *mx = PyMemoryView_FromMemory((char *)x, N * in_size, PyBUF_READ);
  PyObject *my = PyMemoryView_FromMemory((char *)y, N * in_size, PyBUF_READ);
  PyObject *mz = PyMemoryView_FromMemory((char *)z, N * in_size, PyBUF_READ);
  PyObject *mh = PyMemoryView_FromMemory((char *)h, N * h_size, PyBUF_READ);
  PyObject *mm = PyMemoryView_FromMemory((char *)m, N * h_size, PyBUF_READ);
  PyObject *mo = PyMemoryView_FromMemory((char *)nH, N * h_size, PyBUF_WRITE);
  PyObject *result = PyObject_CallMethod(
      cmi_module, "cmi_compute_buffers", "OOOOOOnss", mx, my, mz, mh, mm, mo,
      (Py_ssize_t)N, in_dtype, h_dtype);
  if (result == NULL)
    PyErr_Print();
  Py_XDECREF(result);
  Py_XDECREF(mx);
  Py_XDECREF(my);
  Py_XDECREF(mz);
  Py_XDECREF(mh);
  Py_XDECREF(mm);
  Py_XDECREF(mo);
  PyGILState_Release(gil);
}

void cmi_compute_neutral_fraction_dp(const double *x, const double *y,
                                     const double *z, const double *h,
                                     const double *m, double *nH, size_t N) {
  call_compute(x, y, z, h, m, nH, N, "f8", "f8");
}

void cmi_compute_neutral_fraction_sp(const float *x, const float *y,
                                     const float *z, const float *h,
                                     const float *m, float *nH, size_t N) {
  call_compute(x, y, z, h, m, nH, N, "f4", "f4");
}

void cmi_compute_neutral_fraction_mp(const double *x, const double *y,
                                     const double *z, const float *h,
                                     const float *m, float *nH, size_t N) {
  call_compute(x, y, z, h, m, nH, N, "f8", "f4");
}
