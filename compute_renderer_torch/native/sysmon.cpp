// Native system-metrics sampler — the reference's sysinfo dependency
// equivalent (reference src/performance.rs:66-81 samples global CPU% and
// process RSS every frame). Reads /proc directly; exposed via a C ABI for
// ctypes. Keeping this native keeps the per-frame sampling cost out of the
// Python frame loop (sysinfo's refresh_cpu_all is likewise native Rust).

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

struct CpuTimes {
  uint64_t idle = 0;
  uint64_t total = 0;
};

bool read_cpu_times(CpuTimes* out) {
  FILE* f = fopen("/proc/stat", "rb");
  if (!f) return false;
  char line[512];
  bool ok = false;
  if (fgets(line, sizeof(line), f)) {
    // cpu  user nice system idle iowait irq softirq steal guest guest_nice
    uint64_t v[10] = {0};
    int n = sscanf(line, "cpu %lu %lu %lu %lu %lu %lu %lu %lu %lu %lu",
                   &v[0], &v[1], &v[2], &v[3], &v[4], &v[5], &v[6], &v[7],
                   &v[8], &v[9]);
    if (n >= 4) {
      uint64_t total = 0;
      for (int i = 0; i < n; ++i) total += v[i];
      out->idle = v[3] + (n > 4 ? v[4] : 0);  // idle + iowait
      out->total = total;
      ok = true;
    }
  }
  fclose(f);
  return ok;
}

CpuTimes g_last;

}  // namespace

extern "C" {

// Global CPU usage percent since the previous call (first call returns 0).
// Mirrors sysinfo::System::global_cpu_usage semantics.
double crt_global_cpu_percent() {
  CpuTimes now;
  if (!read_cpu_times(&now)) return 0.0;
  double pct = 0.0;
  if (g_last.total != 0 && now.total > g_last.total) {
    const double dt = static_cast<double>(now.total - g_last.total);
    const double didle = static_cast<double>(now.idle - g_last.idle);
    pct = 100.0 * (dt - didle) / dt;
  }
  g_last = now;
  return pct;
}

// Process resident set size in bytes (sysinfo Process::memory equivalent).
int64_t crt_process_rss_bytes() {
  FILE* f = fopen("/proc/self/statm", "rb");
  if (!f) return 0;
  long size = 0, resident = 0;
  int n = fscanf(f, "%ld %ld", &size, &resident);
  fclose(f);
  if (n < 2) return 0;
  return static_cast<int64_t>(resident) * 4096;
}

}  // extern "C"
