// nmftpu C ABI backed by the PyTorch/CUDA port: embeds CPython and calls
// nmftpu_torch.capi_bridge.compute_from_buffers (the python half of this
// boundary). The same functions and signatures as native/nmftpu_capi.cc,
// declared in this directory's nmftpu_capi.h, so a host program written
// against that header links against either library. Build it with
// nmftpu_torch.capi.build().

#include "nmftpu_capi.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <string>
#include <vector>

namespace {

std::string g_last_error;
std::vector<std::string> g_extra_paths;
bool g_initialized = false;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

}  // namespace

extern "C" {

const char* nmftpu_last_error(void) { return g_last_error.c_str(); }

int32_t nmftpu_set_module_path(const char* path) {
  if (!path) return NMFTPU_ERROR_INVALID_ARGUMENT;
  g_extra_paths.emplace_back(path);
  if (g_initialized) {
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* p = PyUnicode_FromString(path);
    PyList_Insert(sys_path, 0, p);
    Py_DECREF(p);
    PyGILState_Release(gil);
  }
  return NMFTPU_SUCCESS;
}

int32_t nmftpu_initialize(void) {
  g_last_error.clear();
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* sys_path = PySys_GetObject("path");
  for (const auto& p : g_extra_paths) {
    PyObject* o = PyUnicode_FromString(p.c_str());
    PyList_Insert(sys_path, 0, o);
    Py_DECREF(o);
  }
  PyObject* mod = PyImport_ImportModule("nmftpu_torch.capi_bridge");
  int32_t rc = NMFTPU_SUCCESS;
  if (!mod) {
    set_error_from_python();
    rc = NMFTPU_ERROR_PYTHON;
  } else {
    PyObject* res = PyObject_CallMethod(mod, "initialize", nullptr);
    if (!res) {
      set_error_from_python();
      rc = NMFTPU_ERROR_PYTHON;
    } else {
      // bridge returns the reference-style status code (0 = success,
      // 3 = no device) — propagate it instead of reporting SUCCESS on
      // a device-less runtime.
      long code = PyLong_AsLong(res);
      if (PyErr_Occurred()) {
        PyErr_Clear();
        code = 0;  // non-int return: treat as success (legacy bridge)
      }
      Py_DECREF(res);
      if (code == 0) {
        g_initialized = true;
      } else {
        rc = static_cast<int32_t>(code);
        g_last_error = "nmftpu_torch.capi_bridge.initialize returned status " +
                       std::to_string(code);
      }
    }
    Py_DECREF(mod);
  }
  PyGILState_Release(gil);
  if (we_initialized) {
    // Py_InitializeEx leaves the GIL held by THIS thread; release it so
    // other host threads can enter via PyGILState_Ensure (the ABI is
    // documented as callable from any thread).
    (void)PyEval_SaveThread();
  }
  return rc;
}

int32_t nmftpu_finalize(void) {
  g_initialized = false;
  // The embedded interpreter stays up (CUDA contexts do not survive
  // re-initialization); finalize only marks the API closed, matching the
  // reference's context-teardown semantics at process granularity.
  return NMFTPU_SUCCESS;
}

static PyObject* bridge_call(const char* fn, PyObject* args) {
  PyObject* mod = PyImport_ImportModule("nmftpu_torch.capi_bridge");
  if (!mod) return nullptr;
  PyObject* f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (!f) return nullptr;
  PyObject* res = PyObject_CallObject(f, args);
  Py_DECREF(f);
  return res;
}

const char* nmftpu_version(void) {
  static std::string version;
  if (!g_initialized) return "";
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* res = bridge_call("version", nullptr);
  if (res) {
    const char* c = PyUnicode_AsUTF8(res);
    if (c) version = c;
    Py_DECREF(res);
  } else {
    set_error_from_python();
  }
  PyGILState_Release(gil);
  return version.c_str();
}

int32_t nmftpu_device_count(void) {
  if (!g_initialized) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  int32_t count = -1;
  PyObject* res = bridge_call("device_count", nullptr);
  if (res) {
    count = static_cast<int32_t>(PyLong_AsLong(res));
    Py_DECREF(res);
  } else {
    set_error_from_python();
  }
  PyGILState_Release(gil);
  return count;
}

int32_t nmftpu_choose_device(int32_t index) {
  if (!g_initialized) return NMFTPU_ERROR_NOT_INITIALIZED;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* args = Py_BuildValue("(i)", index);
  PyObject* res = bridge_call("choose_device", args);
  Py_DECREF(args);
  int32_t rc = NMFTPU_SUCCESS;
  if (!res) {
    set_error_from_python();
    rc = NMFTPU_ERROR_PYTHON;
  } else {
    rc = static_cast<int32_t>(PyLong_AsLong(res));
    Py_DECREF(res);
  }
  PyGILState_Release(gil);
  return rc;
}

int32_t nmftpu_compute(NmftpuDescription* d) {
  g_last_error.clear();
  if (!g_initialized) return NMFTPU_ERROR_NOT_INITIALIZED;
  if (!d || d->n_rows <= 0 || d->n_cols <= 0 || d->rank <= 0 ||
      !d->out_w || !d->out_h) {
    g_last_error = "invalid description";
    return NMFTPU_ERROR_INVALID_ARGUMENT;
  }
  const bool dense = d->dense_values != nullptr;
  const bool sparse = d->csr_indptr && d->csr_indices && d->csr_values;
  if (dense == sparse) {
    g_last_error = "exactly one of dense_values / CSR must be set";
    return NMFTPU_ERROR_INVALID_ARGUMENT;
  }

  PyGILState_STATE gil = PyGILState_Ensure();
  // Pointers cross as integers; the python bridge wraps them with ctypes.
  PyObject* args = Py_BuildValue(
      "(iii s s s I iii s d"
      " dddddd dd"
      " KKKK L KK KK KK)",
      d->n_rows, d->n_cols, d->rank,
      d->algorithm ? d->algorithm : "mu",
      d->objective ? d->objective : "frobenius",
      d->init_method ? d->init_method : "all_random_values",
      (unsigned int)d->seed,
      d->num_iterations > 0 ? d->num_iterations : 200,
      d->num_runs > 0 ? d->num_runs : 1,
      d->check_interval > 0 ? d->check_interval : 10,
      d->threshold_type ? d->threshold_type : "frobenius",
      d->threshold_value,
      d->lambda_w, d->lambda_h, d->alpha_w, d->alpha_h, d->lambda_tik,
      d->theta, d->alpha_confidence, d->beta,
      (unsigned long long)(uintptr_t)d->dense_values,
      (unsigned long long)(uintptr_t)d->csr_indptr,
      (unsigned long long)(uintptr_t)d->csr_indices,
      (unsigned long long)(uintptr_t)d->csr_values,
      (long long)d->nnz,
      (unsigned long long)(uintptr_t)d->initial_w,
      (unsigned long long)(uintptr_t)d->initial_h,
      (unsigned long long)(uintptr_t)d->out_w,
      (unsigned long long)(uintptr_t)d->out_h,
      (unsigned long long)(uintptr_t)d->stats_callback,
      (unsigned long long)(uintptr_t)d->stats_user_data);
  if (!args) {
    set_error_from_python();
    PyGILState_Release(gil);
    return NMFTPU_ERROR_PYTHON;
  }
  PyObject* res = bridge_call("compute_from_buffers", args);
  Py_DECREF(args);
  int32_t rc = NMFTPU_SUCCESS;
  if (!res) {
    set_error_from_python();
    rc = NMFTPU_ERROR_PYTHON;
  } else {
    double fro = 0.0, rmsd = 0.0;
    int iters = 0, conv = 0;
    if (PyArg_ParseTuple(res, "ddii", &fro, &rmsd, &iters, &conv)) {
      d->frobenius_error = fro;
      d->rmsd = rmsd;
      d->iterations = iters;
      d->converged = conv;
    } else {
      set_error_from_python();
      rc = NMFTPU_ERROR_PYTHON;
    }
    Py_DECREF(res);
  }
  PyGILState_Release(gil);
  return rc;
}

}  // extern "C"
